// The attention body of the two paged-decode kernels for f32 q, on f32 and
// int8 pages, the checking paths (paged_decode.cu, one CTA per (sequence, kv
// head); paged_decode_tiled.cu, one CTA per (sequence, kv head, split)): one
// query token's GQA group attends over a contiguous range of one sequence's
// positions. bf16 q, on either page format, runs the Hopper body of
// paged_decode_sm90.cuh instead.
//
// One thread per lane of the padded head dim (64, 128 or 256; `padded`).
// The range is walked 64 tokens at a time (32 for f32 pages at head_dim
// 256, so two stages fit shared memory) through a two-stage cp.async ring,
// so the next chunk's K and V are in flight while the current one is
// scored. Each token row finds its own page, `table[pos / page_size]`, so
// any page size works (a chunk spans several small pages or half of a
// 128-token page). Rows are padded by 16 bytes so the per-token score loop
// reads shared memory without bank conflicts, and the GQA group shares each
// staged row, so K/V move once per kv head. Int8 rows take the same ring;
// their f32 scales ride along with 4-byte copies and stay out of the inner
// products: score = scale_k * sum(q * k_int8), and P @ V accumulates
// (p * scale_v) * v_int8. The softmax runs online in f32.
//
// Every head dim runs at its padded width (row_copy.cuh): each row of the
// pools' unpadded rows ([.., head_dim]) is copied in pieces of
// `row_piece(row_bytes)` bytes (16 at head_dim 64, 128 and 256; 8, 4, 2 or
// 1 below the padded width), the padded columns of the shared rows and of q
// stay zero, and only the true columns are written.
//
// Also here, for both decode sources and both bodies: how a GQA group maps
// onto CTAs (`n_chunks_of`, `rows_of`), the padded widths, and the dispatch
// over the built (padded head_dim, rows) instantiations (`with_shape`,
// `with_sm90_shape`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "row_copy.cuh"  // padded, row_piece, with_piece, copy_piece, cp_async_*

namespace {

// A decode CTA holds at most max_rows_of(head_dim) query heads (the sm90
// body keeps q and acc for each in registers: 8 up to head_dim 128, 4 above,
// where a lane holds 16 columns). A GQA group above that runs as
// n_chunks_of chunks of rows_of rows each over the same kv head, one more
// CTA (or cluster) per chunk: group 12 as 2 x 6, 16 as 2 x 8, 13 as 2 x 7
// (the last chunk's seventh row does not exist), 71 as 9 x 8. Each chunk
// reads the kv head's pages again, so a group of g > 8 moves ceil(g / 8)
// times the K/V bytes of one pass. ops/paged_attention.py (`group_chunks`)
// follows the same rule.
constexpr int kMaxRows = 8;
__host__ __device__ constexpr int max_rows_of(int head_dim) {
  return head_dim > 128 ? kMaxRows / 2 : kMaxRows;
}
__host__ __device__ constexpr int n_chunks_of(int group, int head_dim) {
  return (group + max_rows_of(head_dim) - 1) / max_rows_of(head_dim);
}
__host__ __device__ constexpr int rows_of(int group, int head_dim) {
  return (group + n_chunks_of(group, head_dim) - 1) / n_chunks_of(group, head_dim);
}

// Grid row y of a decode launch is the pair (kv head h, chunk): the chunk's
// first query row in the sequence's q, and how many of its `rows` (rows_of)
// exist. (No chunk is empty, so a group runs in ceil(group / rows) chunks.)
struct ChunkRows {
  int h, row0, n_rows;
};
__device__ __forceinline__ ChunkRows chunk_rows(int y, int group, int rows) {
  const int n_chunks = (group + rows - 1) / rows;
  const int h = y / n_chunks;
  const int chunk = y % n_chunks;
  return {h, h * group + chunk * rows, min(rows, group - chunk * rows)};
}

// launch(std::integral_constant<int, HD>, std::integral_constant<int, ROWS>)
// for the instantiation that serves head_dim (HD its padded width) and rows;
// cudaErrorInvalidValue for a shape no kernel is built for.
template <int ROWS, typename F>
cudaError_t with_head_dim(int head_dim, F& launch) {
  switch (padded(head_dim)) {
    case 64:
      return launch(std::integral_constant<int, 64>{}, std::integral_constant<int, ROWS>{});
    case 128:
      return launch(std::integral_constant<int, 128>{}, std::integral_constant<int, ROWS>{});
    case 256:
      if constexpr (ROWS <= max_rows_of(256)) {
        return launch(std::integral_constant<int, 256>{}, std::integral_constant<int, ROWS>{});
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}
// launch(std::integral_constant<int, HD>) for head_dim's padded width: the
// f32-q body, built once a width at max_rows_of(HD) rows, takes any chunk's
// rows at run time.
template <typename F>
cudaError_t with_padded(int head_dim, F&& launch) {
  switch (padded(head_dim)) {
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}
template <typename F>
cudaError_t with_shape(int head_dim, int rows, F&& launch) {
  switch (rows) {
    case 1: return with_head_dim<1>(head_dim, launch);
    case 2: return with_head_dim<2>(head_dim, launch);
    case 3: return with_head_dim<3>(head_dim, launch);
    case 4: return with_head_dim<4>(head_dim, launch);
    case 5: return with_head_dim<5>(head_dim, launch);
    case 6: return with_head_dim<6>(head_dim, launch);
    case 7: return with_head_dim<7>(head_dim, launch);
    case 8: return with_head_dim<8>(head_dim, launch);
    default: return cudaErrorInvalidValue;
  }
}
// launch(std::integral_constant<int, HD>, std::integral_constant<int, ROWS>,
// std::bool_constant<BULK>) for the Hopper body's instantiation that serves
// head_dim and a chunk of `rows` query heads. At the padded width (BULK: the
// rows are whole 16-byte multiples, one bulk copy a page piece) it is built
// for every rows, as the shape. Below it (rows copied in pieces) it is built
// at ROWS 1 (a group of 1) and at max_rows_of(HD) for every other group,
// the chunk's rows then passed at run time: 6 instantiations a page format
// where the rows would take 20, which keeps the build short, at the cost of
// idle rows' arithmetic for groups of 2 to 7 at such head dims.
template <typename F>
cudaError_t with_sm90_shape(int head_dim, int rows, F&& launch) {
  if (head_dim == padded(head_dim)) {
    return with_shape(head_dim, rows, [&](auto hd, auto r) {
      return launch(hd, r, std::true_type{});
    });
  }
  return with_padded(head_dim, [&](auto hd) {
    constexpr int kMost = max_rows_of(decltype(hd)::value);
    return rows == 1 ? launch(hd, std::integral_constant<int, 1>{}, std::false_type{})
                     : launch(hd, std::integral_constant<int, kMost>{}, std::false_type{});
  });
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// TKV: the storage type of the pages, the type of q itself or int8_t (then
// with f32 per-row scales). HD: the padded head dim.
template <typename TKV, int HD, int ROWS>
struct DecodeSmem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  // Tokens a stage: 64, or 32 where two stages of 64 rows would not fit.
  static constexpr int kChunk = sizeof(TKV) * HD > 512 ? 32 : 64;
  static constexpr int kVec = 16 / sizeof(TKV);  // elements per 16 bytes
  static constexpr int kRow = HD + kVec;         // padded K/V row, elements
  static constexpr size_t kv_bytes = 2ull * kChunk * kRow * sizeof(TKV);
  static constexpr size_t scale_floats = kQuant ? 2 * 2 * kChunk : 0;
  static constexpr size_t bytes =
      2 * kv_bytes +
      sizeof(float) * (scale_floats + ROWS * HD + ROWS * kChunk + 3 * ROWS);
};

// Attend the ROWS query heads at q_group ([ROWS][hd]; rows from n_rows on
// do not exist and read as zeros) over positions [pos0, pos_end) of one
// sequence and kv head (`table`: the sequence's block
// table row; `head_page0`: h * n_pages), masking positions below win_lo.
// Leaves this thread's lane of the unnormalized output in acc (lanes from
// hd on hold zeros) and each group row's running max and normalizer in m
// and l (m = -inf, l = 0 when nothing was attended). Every thread of the
// CTA (HD, the padded head dim) must call it.
template <typename TQ, typename TKV, int HD, int ROWS>
__device__ __forceinline__ void attend_range(
    const TQ* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    size_t head_page0, int n_pages, int page_size, int pos0, int pos_end,
    int win_lo, float scale, int n_rows, int hd, float (&acc)[ROWS], float (&m)[ROWS],
    float (&l)[ROWS]) {
  using SM = DecodeSmem<TKV, HD, ROWS>;
  constexpr bool kQuant = SM::kQuant;
  constexpr int kChunk = SM::kChunk;
  constexpr int kPer = kChunk / 32;  // scores a lane takes in the softmax
  constexpr int kThreads = HD;  // one thread per output lane
  constexpr int kWarps = kThreads / 32;
  constexpr int kVec = SM::kVec;
  constexpr int kRow = SM::kRow;
  constexpr int kVecPerRow = HD / kVec;
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);                // [2][kChunk][kRow]
  TKV* vs = reinterpret_cast<TKV*>(smem + SM::kv_bytes);  // [2][kChunk][kRow]
  float* kss = reinterpret_cast<float*>(smem + 2 * SM::kv_bytes);  // [2][kChunk]
  float* vss = kss + (kQuant ? 2 * kChunk : 0);                    // [2][kChunk]
  float* qs = kss + SM::scale_floats;  // [ROWS][HD]
  float* ss = qs + ROWS * HD;         // [ROWS][kChunk] scores, then probs
  float* m_s = ss + ROWS * kChunk;    // [ROWS] running max
  float* l_s = m_s + ROWS;            // [ROWS] running normalizer
  float* a_s = l_s + ROWS;            // [ROWS] this chunk's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = pos_end > pos0 ? (pos_end - pos0 + kChunk - 1) / kChunk : 0;

  for (int i = tid; i < ROWS * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    qs[i] = g < n_rows && d < hd ? to_f(q_group[g * hd + d]) : 0.f;
  }
  if (tid < ROWS) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // The copies below write a row's first hd columns only: the padded
  // columns of every staged row stay zero.
  if (hd < HD) {
    for (int i = tid; i < 2 * 2 * kChunk * (HD - hd); i += kThreads) {
      const int r = i / (HD - hd);
      (r < 2 * kChunk ? ks + r * kRow : vs + (r - 2 * kChunk) * kRow)[hd + i % (HD - hd)] =
          TKV(0);
    }
  }

  // Stage chunk c (positions pos0 + c*kChunk ...) into `stage`.
  auto load_chunk = [&](int stage, int c) {
    const int c_start = pos0 + c * kChunk;
    TKV* kd = ks + stage * kChunk * kRow;
    TKV* vd = vs + stage * kChunk * kRow;
    with_piece<sizeof(TKV)>(row_bytes, [&](auto piece) {
      constexpr int G = decltype(piece)::value;
      const int pieces = row_bytes / G;
      for (int i = tid; i < kChunk * pieces; i += kThreads) {
        const int t = i / pieces;
        const int off = (i - t * pieces) * G;
        const int pos = c_start + t;
        if (pos >= pos_end) continue;
        const int page = table[pos / page_size];
        if (page < 0 || page >= n_pages) continue;
        const size_t row = (head_page0 + page) * page_size + pos % page_size;
        copy_piece<G>(reinterpret_cast<unsigned char*>(kd + t * kRow) + off,
                      reinterpret_cast<const unsigned char*>(k_pages + row * hd) + off);
        copy_piece<G>(reinterpret_cast<unsigned char*>(vd + t * kRow) + off,
                      reinterpret_cast<const unsigned char*>(v_pages + row * hd) + off);
      }
    });
    if constexpr (kQuant) {
      for (int t = tid; t < kChunk; t += kThreads) {
        const int pos = c_start + t;
        if (pos >= pos_end) continue;
        const int page = table[pos / page_size];
        if (page < 0 || page >= n_pages) continue;
        const size_t row = (head_page0 + page) * page_size + pos % page_size;
        copy_piece<4>(kss + stage * kChunk + t, k_scales + row);
        copy_piece<4>(vss + stage * kChunk + t, v_scales + row);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int g = 0; g < ROWS; ++g) acc[g] = 0.f;

  if (n_chunks > 0) load_chunk(0, 0);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_chunks) {
      load_chunk(stage ^ 1, c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const TKV* kc = ks + stage * kChunk * kRow;
    const TKV* vc = vs + stage * kChunk * kRow;
    const float* ksc = kss + stage * kChunk;
    const float* vsc = vss + stage * kChunk;
    const int c_start = pos0 + c * kChunk;
    const int t_end = min(kChunk, pos_end - c_start);

    // Scores: one (group row, token) pair per thread per step.
    for (int p = tid; p < ROWS * kChunk; p += kThreads) {
      const int g = p / kChunk;
      const int t = p % kChunk;
      const int pos = c_start + t;
      const bool live = t < t_end && pos >= win_lo;
      float s = -INFINITY;
      if (live) {
        const float* qg = qs + g * HD;
        const uint4* kr = reinterpret_cast<const uint4*>(kc + t * kRow);
        float dot = 0.f;
#pragma unroll 4
        for (int vec = 0; vec < kVecPerRow; ++vec) {
          const uint4 raw = kr[vec];
          const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot += qg[vec * kVec + j] * to_f(e[j]);
        }
        if constexpr (kQuant) dot *= ksc[t];
        s = dot * scale;
      }
      ss[p] = s;
    }
    __syncthreads();

    // Online softmax, one warp per group row; probabilities (times the V
    // row scales for int8 pages) overwrite ss.
    for (int g = warp; g < ROWS; g += kWarps) {
      const float m_prev = m_s[g];
      float s[kPer];
      float m_cur = -INFINITY;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s[u] = ss[g * kChunk + lane + 32 * u];
        m_cur = fmaxf(m_cur, s[u]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      }
      const float m_new = fmaxf(m_prev, m_cur);
      // A row with nothing valid yet keeps m == -inf: pin the rescale to 0
      // and subtract 0 instead (exp(-inf - -inf) would be NaN).
      const float alpha = m_new == -INFINITY ? 0.f : expf(m_prev - m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const float p = s[u] == -INFINITY ? 0.f : expf(s[u] - base);
        if constexpr (kQuant) {
          // Masked slots may hold stale scales: keep their weight exactly 0.
          ss[g * kChunk + lane + 32 * u] = p == 0.f ? 0.f : p * vsc[lane + 32 * u];
        } else {
          ss[g * kChunk + lane + 32 * u] = p;
        }
        sum += p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P @ V: this thread's head_dim lane for every group row.
#pragma unroll
    for (int g = 0; g < ROWS; ++g) acc[g] *= a_s[g];
    for (int t = 0; t < t_end; ++t) {
      const float vv = to_f(vc[t * kRow + tid]);
#pragma unroll
      for (int g = 0; g < ROWS; ++g) acc[g] += ss[g * kChunk + t] * vv;
    }
    __syncthreads();  // the stage and ss are rewritten next step
  }

#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    m[g] = m_s[g];
    l[g] = l_s[g];
  }
}

}  // namespace
