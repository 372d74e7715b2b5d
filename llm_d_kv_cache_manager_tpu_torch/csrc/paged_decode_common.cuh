// The attention body of the two paged-decode kernels for f32 q, on f32 and
// int8 pages, the checking paths (paged_decode.cu, one CTA per (sequence, kv
// head); paged_decode_tiled.cu, one CTA per (sequence, kv head, split)): one
// query token's GQA group attends over a contiguous range of one sequence's
// positions. bf16 q, on either page format, runs the Hopper body of
// paged_decode_sm90.cuh instead.
//
// One thread per head_dim lane. The range is walked 64 tokens at a time
// through a two-stage cp.async ring, so the next chunk's K and V are in
// flight while the current one is scored. Each token row finds its own page,
// `table[pos / page_size]`, so any page size works (a chunk spans several
// small pages or half of a 128-token page). Copies are 16 bytes, rows are
// padded by 16 bytes so the per-token score loop reads shared memory without
// bank conflicts, and the GQA group shares each staged row, so K/V move once
// per kv head. Int8 rows (128 bytes) take the same ring; their f32 scales
// ride along with 4-byte copies and stay out of the inner products:
// score = scale_k * sum(q * k_int8), and P @ V accumulates
// (p * scale_v) * v_int8. The softmax runs online in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 64;  // tokens staged per pipeline step

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TKV: the storage type of the pages, the type of q itself or int8_t (then
// with f32 per-row scales).
template <typename TKV, int HD, int GROUP>
struct DecodeSmem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte copy
  static constexpr int kRow = HD + kVec;         // padded K/V row, elements
  static constexpr size_t kv_bytes = 2ull * kChunk * kRow * sizeof(TKV);
  static constexpr size_t scale_floats = kQuant ? 2 * 2 * kChunk : 0;
  static constexpr size_t bytes =
      2 * kv_bytes +
      sizeof(float) * (scale_floats + GROUP * HD + GROUP * kChunk + 3 * GROUP);
};

// Attend the GROUP query heads at q_group ([GROUP][HD]) over positions
// [pos0, pos_end) of one sequence and kv head (`table`: the sequence's block
// table row; `head_page0`: h * n_pages), masking positions below win_lo.
// Leaves this thread's lane of the unnormalized output in acc and each
// group row's running max and normalizer in m and l (m = -inf, l = 0 when
// nothing was attended). Every thread of the CTA must call it.
template <typename TQ, typename TKV, int HD, int GROUP>
__device__ __forceinline__ void attend_range(
    const TQ* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    size_t head_page0, int n_pages, int page_size, int pos0, int pos_end,
    int win_lo, float scale, float (&acc)[GROUP], float (&m)[GROUP],
    float (&l)[GROUP]) {
  using SM = DecodeSmem<TKV, HD, GROUP>;
  constexpr bool kQuant = SM::kQuant;
  constexpr int kThreads = HD;  // one thread per output lane
  constexpr int kWarps = kThreads / 32;
  constexpr int kVec = SM::kVec;
  constexpr int kRow = SM::kRow;
  constexpr int kVecPerRow = HD / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);                // [2][kChunk][kRow]
  TKV* vs = reinterpret_cast<TKV*>(smem + SM::kv_bytes);  // [2][kChunk][kRow]
  float* kss = reinterpret_cast<float*>(smem + 2 * SM::kv_bytes);  // [2][kChunk]
  float* vss = kss + (kQuant ? 2 * kChunk : 0);                    // [2][kChunk]
  float* qs = kss + SM::scale_floats;  // [GROUP][HD]
  float* ss = qs + GROUP * HD;         // [GROUP][kChunk] scores, then probs
  float* m_s = ss + GROUP * kChunk;    // [GROUP] running max
  float* l_s = m_s + GROUP;            // [GROUP] running normalizer
  float* a_s = l_s + GROUP;            // [GROUP] this chunk's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = pos_end > pos0 ? (pos_end - pos0 + kChunk - 1) / kChunk : 0;

  for (int i = tid; i < GROUP * HD; i += kThreads) qs[i] = to_f(q_group[i]);
  if (tid < GROUP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Stage chunk c (positions pos0 + c*kChunk ...) into `stage`.
  auto load_chunk = [&](int stage, int c) {
    const int c_start = pos0 + c * kChunk;
    TKV* kd = ks + stage * kChunk * kRow;
    TKV* vd = vs + stage * kChunk * kRow;
    for (int i = tid; i < kChunk * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int vec = i % kVecPerRow;
      const int pos = c_start + t;
      if (pos >= pos_end) continue;
      const int page = table[pos / page_size];
      if (page < 0 || page >= n_pages) continue;
      const size_t row = (head_page0 + page) * page_size + pos % page_size;
      cp_async16(kd + t * kRow + vec * kVec, k_pages + row * HD + vec * kVec);
      cp_async16(vd + t * kRow + vec * kVec, v_pages + row * HD + vec * kVec);
      if (kQuant && vec == 0) {
        cp_async4(kss + stage * kChunk + t, k_scales + row);
        cp_async4(vss + stage * kChunk + t, v_scales + row);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int g = 0; g < GROUP; ++g) acc[g] = 0.f;

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
    for (int p = tid; p < GROUP * kChunk; p += kThreads) {
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
    for (int g = warp; g < GROUP; g += kWarps) {
      const float m_prev = m_s[g];
      const float s0 = ss[g * kChunk + lane];
      const float s1 = ss[g * kChunk + lane + 32];
      float m_cur = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      }
      const float m_new = fmaxf(m_prev, m_cur);
      // A row with nothing valid yet keeps m == -inf: pin the rescale to 0
      // and subtract 0 instead (exp(-inf - -inf) would be NaN).
      const float alpha = m_new == -INFINITY ? 0.f : expf(m_prev - m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - base);
      const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - base);
      if constexpr (kQuant) {
        // Masked slots may hold stale scales: keep their weight exactly 0.
        ss[g * kChunk + lane] = p0 == 0.f ? 0.f : p0 * vsc[lane];
        ss[g * kChunk + lane + 32] = p1 == 0.f ? 0.f : p1 * vsc[lane + 32];
      } else {
        ss[g * kChunk + lane] = p0;
        ss[g * kChunk + lane + 32] = p1;
      }
      float sum = p0 + p1;
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
    for (int g = 0; g < GROUP; ++g) acc[g] *= a_s[g];
    for (int t = 0; t < t_end; ++t) {
      const float vv = to_f(vc[t * kRow + tid]);
#pragma unroll
      for (int g = 0; g < GROUP; ++g) acc[g] += ss[g * kChunk + t] * vv;
    }
    __syncthreads();  // the stage and ss are rewritten next step
  }

#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = m_s[g];
    l[g] = l_s[g];
  }
}

}  // namespace
