// Paged decoding attention at head dims above 256 for Hopper (sm_90a), both
// decode variants, both q dtypes and both page formats: `kvt_paged_decode_wide`
// (one launch per call; for bf16 q the splits of each (sequence, kv head,
// chunk, slab) form a thread-block cluster, as in paged_decode.cu) and
// `kvt_paged_decode_wide_tiled` (a grid split and a combine pass, as in
// paged_decode_tiled.cu). ops/paged_attention.py calls these for a head dim
// above 256 and paged_decode.cu / paged_decode_tiled.cu below it.
//
// Replaces, at those head dims, the TPU kernels `_decode_kernel_pipelined`
// and `_decode_kernel` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157 and :78), and their
// `quantized=True` instantiations (ops/quantized_kv.py:93 and :125): one
// query token per sequence over its block table, online softmax in f32
// (scale 1/sqrt(head_dim)), mask `pos < seq_len` and, windowed, `pos >=
// seq_len - window`; `seq_len == 0` writes zeros; no atomics (two calls give
// the same bits).
//
// Bound on this card: bytes, as below 256. At 4/2 heads of 512 and batch 8 x
// 2,048 tokens a layer call must move 67.2 MB on bf16 pages (20.0 us at
// 3.35 TB/s), as the flagship's 16/8 heads of 128.
//
// Why a body of its own: at head dim 512 the other bodies' resident state
// outgrows the SM. The Hopper body's lane (paged_decode_sm90.cuh) would hold
// 32 columns of q and acc for 4 query heads (256 f32 registers), and three
// 64-token stages of bf16 K and V are 384 KB against 227 KB of shared
// memory; the f32-q body (paged_decode_common.cuh) takes a thread a column
// (1,024 at head dim 1,024, none past it). So the output is cut into column
// slabs of kPanel (256) columns, one CTA (or cluster) a slab, and each CTA
// computes the scores over the full head dim by walking K in panels of
// kPanel columns (row_copy.cuh, `n_panels`):
//  - 256 threads, one a column of the slab: acc for every query head of the
//    chunk in registers, as the f32-q body. The range is walked kChunk
//    tokens at a time (64; 32 on f32 pages). Each chunk takes P + 1 tiles
//    of kChunk x kPanel in turn (P = n_panels(hd)): K's panels 0 .. P - 1,
//    then V's panel of this slab. A K panel adds its columns' share to the
//    chunk's scores (one (query head, token) pair a thread, q's panel staged
//    beside it as f32); the V tile runs the online softmax (f32, natural
//    exponent) and P @ V. No head dim is too wide: only P grows.
//  - The tiles pass through a two-stage cp.async ring, the next tile in
//    flight while one is used. Rows are copied in pieces of
//    `row_piece(row_bytes)` bytes (a bf16 row of 300 is 600 bytes, 8-byte
//    aligned), and the columns past hd and the positions outside the range
//    or off the pool are zero-filled, so no stale value enters a product.
//  - Int8 pages: a chunk's K and V scales ride with its first K panel (one
//    scale buffer per chunk parity), so a CTA reads a row's scales once,
//    whatever the number of panels (every slab's CTA reads them, 8 bytes a
//    row beside its K and V panels): score = k_scale * (sum over panels of
//    q * k_int8), and P @ V takes p * v_scale.
// Bytes: every slab reads K again, so at head dim 512 (two slabs) a call
// moves 1.5x the K/V bytes of one pass, and computes Q K^T once a slab. A
// CTA holds max_rows_of(hd) = 4 query heads (paged_decode_common.cuh), the
// rule above head dim 128, so a group above 4 runs in chunks as there: the
// grid's kv-head axis is (kv head, chunk, slab).
//
// A source of its own: its instantiations build in parallel with the other
// decode sources (one nvcc each), and those keep the narrower heads' code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "paged_decode_common.cuh"  // to_f, from_f, cp_async_*, ChunkRows, rows_of
#include "paged_decode_sm90.cuh"    // sm90::set_attributes
#include "row_copy.cuh"             // kPanel, n_panels, row_piece, with_piece, copy_piece

namespace {

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

namespace wide {

constexpr int kThreads = kPanel;  // one thread a column of the slab
constexpr int kWarps = kThreads / 32;
constexpr int kRows = max_rows_of(kPanel + 1);  // query heads a CTA holds

// TKV: the pages' type (q's, or int8_t with f32 per-row scales). The ring's
// tiles are [kChunk][kRow], rows padded by 16 bytes against bank conflicts
// in the score loop.
template <typename TKV>
struct Smem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr int kChunk = sizeof(TKV) == 4 ? 32 : 64;  // tokens a chunk
  static constexpr int kVec = 16 / sizeof(TKV);               // elements per 16 bytes
  static constexpr int kRow = kPanel + kVec;                  // tile row, elements
  static constexpr size_t tile_bytes = sizeof(TKV) * kChunk * kRow;
  static constexpr size_t scale_floats = kQuant ? 2 * 2 * kChunk : 0;  // [parity][K, V][kChunk]
  static constexpr size_t bytes =
      2 * tile_bytes + sizeof(float) * (scale_floats + kRows * kPanel + kRows * kChunk + 3 * kRows);
  // After the range the ring holds the CTA's partial: acc [kRows][kPanel],
  // m [kRows], l [kRows].
  static_assert(sizeof(float) * (kRows * kPanel + 2 * kRows) <= 2 * tile_bytes,
                "the partial fits the ring");
};

// Attend the query heads at q_group ([kRows][hd], type TQ; rows from n_rows
// on do not exist and read as zeros) over positions [pos0, pos_end) of one
// sequence and kv head (`table`: the sequence's block-table row;
// `head_page0`: h * n_pages), masking positions below win_lo, for the
// output columns of slab `slab` (kPanel * slab onwards). Every thread of
// the CTA (kThreads) must call it. On return (after a CTA barrier) the
// CTA's partial lies in shared memory at the returned pointer: acc
// [kRows][kPanel] (unnormalized, column c of the slab at c; zero past hd),
// m [kRows] (natural log domain; -inf where nothing was attended), l
// [kRows].
template <typename TQ, typename TKV>
__device__ __forceinline__ const float* attend_range(
    const TQ* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table, size_t head_page0,
    int n_pages, int page_size, int pos0, int pos_end, int win_lo, float scale, int n_rows,
    int hd, int slab) {
  using SM = Smem<TKV>;
  constexpr bool kQuant = SM::kQuant;
  constexpr int kChunk = SM::kChunk;
  constexpr int kPer = kChunk / 32;  // scores a lane takes in the softmax
  constexpr int kVec = SM::kVec;
  constexpr int kRow = SM::kRow;
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  const int n_pan = n_panels(hd);
  const int per_chunk = n_pan + 1;  // tiles a chunk: K's panels, then V's

  extern __shared__ __align__(16) unsigned char wide_smem[];
  TKV* tiles = reinterpret_cast<TKV*>(wide_smem);  // [2][kChunk][kRow]
  float* scales = reinterpret_cast<float*>(wide_smem + 2 * SM::tile_bytes);
  float* qs = scales + SM::scale_floats;  // [kRows][kPanel]: q's panel
  float* ss = qs + kRows * kPanel;        // [kRows][kChunk]: scores, then probs
  float* m_s = ss + kRows * kChunk;       // [kRows] running max
  float* l_s = m_s + kRows;               // [kRows] running normalizer
  float* a_s = l_s + kRows;               // [kRows] this chunk's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = pos_end > pos0 ? (pos_end - pos0 + kChunk - 1) / kChunk : 0;
  const int n_tiles = n_chunks * per_chunk;

  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Tile i: chunk i / per_chunk; K's panel i % per_chunk, or at n_pan V's
  // panel of this slab. Each tile row is the panel's kPanel columns, zero
  // past hd, and zero for a position outside the range or off the pool.
  auto load_tile = [&](int stage, int i) {
    const int c = i / per_chunk;
    const int p = i - c * per_chunk;
    const int col0 = (p < n_pan ? p : slab) * kPanel * static_cast<int>(sizeof(TKV));
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p < n_pan ? k_pages
                                                                                : v_pages);
    const int c_start = pos0 + c * kChunk;
    unsigned char* dst = reinterpret_cast<unsigned char*>(tiles + stage * kChunk * kRow);
    with_piece<sizeof(TKV)>(row_bytes, [&](auto piece) {
      constexpr int G = decltype(piece)::value;
      constexpr int kPieces = kPanel * static_cast<int>(sizeof(TKV)) / G;  // of a tile row
      for (int x = tid; x < kChunk * kPieces; x += kThreads) {
        const int t = x / kPieces;
        const int off = col0 + (x - t * kPieces) * G;
        const int pos = c_start + t;
        const int page = pos < pos_end ? table[pos / page_size] : -1;
        const bool ok = page >= 0 && page < n_pages && off < row_bytes;
        const size_t row = ok ? (head_page0 + page) * page_size + pos % page_size : 0;
        copy_piece<G>(dst + (t * kRow * sizeof(TKV) + off - col0),
                      src + (ok ? row * row_bytes + off : 0), ok);
      }
    });
    if constexpr (kQuant) {
      if (p == 0) {  // the chunk's K scales, then its V scales
        float* sc = scales + (c & 1) * 2 * kChunk;
        for (int x = tid; x < 2 * kChunk; x += kThreads) {
          const int pos = c_start + x % kChunk;
          const int page = pos < pos_end ? table[pos / page_size] : -1;
          const bool ok = page >= 0 && page < n_pages;
          const size_t row = ok ? (head_page0 + page) * page_size + pos % page_size : 0;
          copy_piece<4>(sc + x, (x < kChunk ? k_scales : v_scales) + row, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[kRows];
#pragma unroll
  for (int g = 0; g < kRows; ++g) acc[g] = 0.f;
  if (n_tiles > 0) load_tile(0, 0);
  __syncthreads();  // m_s and l_s

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {
      load_tile(stage ^ 1, i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int c = i / per_chunk;
    const int p = i - c * per_chunk;
    const TKV* tile = tiles + stage * kChunk * kRow;
    if (p < n_pan) {
      // q's panel p, f32.
      for (int x = tid; x < kRows * kPanel; x += kThreads) {
        const int g = x / kPanel;
        const int col = p * kPanel + x % kPanel;
        qs[x] = g < n_rows && col < hd ? to_f(q_group[g * hd + col]) : 0.f;
      }
      __syncthreads();
      // This panel's share of every (query head, token) score.
      for (int pr = tid; pr < kRows * kChunk; pr += kThreads) {
        const float* qg = qs + (pr / kChunk) * kPanel;
        const uint4* kr = reinterpret_cast<const uint4*>(tile + (pr % kChunk) * kRow);
        float dot = 0.f;
#pragma unroll 4
        for (int vec = 0; vec < kPanel / kVec; ++vec) {
          const uint4 raw = kr[vec];
          const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
          for (int x = 0; x < kVec; ++x) dot += qg[vec * kVec + x] * to_f(e[x]);
        }
        ss[pr] = p == 0 ? dot : ss[pr] + dot;
      }
      __syncthreads();  // q's panel and the stage are rewritten next
      continue;
    }

    // V's tile: online softmax, one warp a query head; probabilities (times
    // the V row scales on int8 pages) overwrite ss.
    const float* ksc = scales + (c & 1) * 2 * kChunk;
    const float* vsc = ksc + kChunk;
    const int c_start = pos0 + c * kChunk;
    const int t_end = min(kChunk, pos_end - c_start);
    for (int g = warp; g < kRows; g += kWarps) {
      const float m_prev = m_s[g];
      float s[kPer];
      float m_cur = -INFINITY;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int t = lane + 32 * u;
        const bool live = t < t_end && c_start + t >= win_lo;
        s[u] = live ? ss[g * kChunk + t] * (kQuant ? ksc[t] : 1.f) * scale : -INFINITY;
        m_cur = fmaxf(m_cur, s[u]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      }
      const float m_new = fmaxf(m_prev, m_cur);
      // A head with nothing live yet keeps m == -inf: pin the rescale to 0
      // and subtract 0 instead (exp(-inf - -inf) would be NaN).
      const float alpha = m_new == -INFINITY ? 0.f : expf(m_prev - m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int t = lane + 32 * u;
        const float pr = s[u] == -INFINITY ? 0.f : expf(s[u] - base);
        ss[g * kChunk + t] = kQuant && pr != 0.f ? pr * vsc[t] : pr;
        sum += pr;
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

    // P @ V: this thread's column of the slab for every query head.
#pragma unroll
    for (int g = 0; g < kRows; ++g) acc[g] *= a_s[g];
    for (int t = 0; t < t_end; ++t) {
      const float vv = to_f(tile[t * kRow + tid]);
#pragma unroll
      for (int g = 0; g < kRows; ++g) acc[g] += ss[g * kChunk + t] * vv;
    }
    __syncthreads();  // the stage and ss are rewritten next
  }

  float* part = reinterpret_cast<float*>(wide_smem);  // the ring is free
#pragma unroll
  for (int g = 0; g < kRows; ++g) part[g * kPanel + tid] = acc[g];
  if (tid < kRows) {
    part[kRows * kPanel + tid] = m_s[tid];
    part[kRows * kPanel + kRows + tid] = l_s[tid];
  }
  __syncthreads();
  return part;
}

}  // namespace wide

// Pipelined (one launch): rank blockIdx.x of the cluster of (sequence
// blockIdx.z; kv head, chunk and slab blockIdx.y) attends over its share of
// the live pages for its slab's columns; after a cluster barrier each rank
// merges kPanel / cluster columns of the slab from every rank through
// distributed shared memory, in rank order, and writes the normalized
// output; a second barrier keeps every CTA's shared memory alive until its
// peers have read it. f32 q takes clusters of one CTA.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(wide::kThreads) paged_decode_wide_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    TQ* __restrict__ out, int n_q, int group, int n_pages, int page_size, int table_width,
    int window, float scale, int hd, int rows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_slabs = n_panels(hd);
  const int slab = blockIdx.y % n_slabs;
  const ChunkRows c = chunk_rows(blockIdx.y / n_slabs, group, rows);
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  // Positions past the table do not exist, as in the plain version's gather.
  const int kv_len = min(seq_len, table_width * page_size);
  const int first_page = window < 0 ? 0 : max(seq_len - window, 0) / page_size;
  const int win_lo = window < 0 ? 0 : seq_len - window;
  const int n_seq_pages = (kv_len + page_size - 1) / page_size;
  const int per_rank = (max(n_seq_pages - first_page, 0) + n_ranks - 1) / n_ranks;
  const int lo_page = first_page + rank * per_rank;
  const int hi_page = min(lo_page + per_rank, n_seq_pages);
  const size_t q0 = (static_cast<size_t>(b) * n_q + c.row0) * hd;

  const float* part = wide::attend_range<TQ, TKV>(
      q + q0, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width, static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo, scale,
      c.n_rows, hd, slab);

  cluster.sync();  // every rank's partial is in its shared memory
  constexpr int R = wide::kRows;
  const int cols = kPanel / n_ranks;  // of the slab, merged by this rank
  for (int i = threadIdx.x; i < c.n_rows * cols; i += blockDim.x) {
    const int g = i / cols;
    const int col = rank * cols + i % cols;
    float mm = -INFINITY;
    for (int r = 0; r < n_ranks; ++r) {
      mm = fmaxf(mm, cluster.map_shared_rank(part, r)[R * kPanel + g]);
    }
    float ll = 0.f, a = 0.f;
    if (mm != -INFINITY) {
      for (int r = 0; r < n_ranks; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float mr = pr[R * kPanel + g];
        if (mr == -INFINITY) continue;  // a rank with no live position
        const float f = expf(mr - mm);
        ll = fmaf(f, pr[R * kPanel + R + g], ll);
        a = fmaf(f, pr[g * kPanel + col], a);
      }
    }
    const int out_col = slab * kPanel + col;
    if (out_col < hd) out[q0 + g * hd + out_col] = from_f<TQ>(ll == 0.f ? 0.f : a / ll);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

// Split-KV, first pass: the partial of one (sequence, kv head, chunk,
// slab) over one split of its pages. Workspace: m/l [batch, n_kv * n_chunks,
// n_splits, rows], acc [.., rows, hd], f32; this CTA writes its slab's
// columns of acc, and slab 0 also m and l (every slab computes the same
// scores, so the same m and l).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(wide::kThreads) split_decode_wide_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    float* __restrict__ m_ws, float* __restrict__ l_ws, float* __restrict__ acc_ws, int n_q,
    int group, int n_pages, int page_size, int table_width, int window, float scale, int hd,
    int rows) {
  const int n_slabs = n_panels(hd);
  const int slab = blockIdx.y % n_slabs;
  const int y = blockIdx.y / n_slabs;  // kv head and chunk
  const int b = blockIdx.x;
  const ChunkRows c = chunk_rows(y, group, rows);
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int seq_len = seq_lens[b];
  const int kv_len = min(seq_len, table_width * page_size);
  const int first_page = window < 0 ? 0 : max(seq_len - window, 0) / page_size;
  const int win_lo = window < 0 ? 0 : seq_len - window;
  const int n_seq_pages = (kv_len + page_size - 1) / page_size;
  const int per_split = (max(n_seq_pages - first_page, 0) + n_splits - 1) / n_splits;
  const int lo_page = first_page + split * per_split;
  const int hi_page = min(lo_page + per_split, n_seq_pages);

  const float* part = wide::attend_range<TQ, TKV>(
      q + (static_cast<size_t>(b) * n_q + c.row0) * hd, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width, static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo, scale,
      c.n_rows, hd, slab);

  const size_t slot = (static_cast<size_t>(b) * (gridDim.y / n_slabs) + y) * n_splits + split;
  for (int i = threadIdx.x; i < rows * kPanel; i += blockDim.x) {
    const int col = slab * kPanel + i % kPanel;
    if (col < hd) acc_ws[(slot * rows + i / kPanel) * hd + col] = part[i];
  }
  if (slab == 0 && static_cast<int>(threadIdx.x) < rows) {
    m_ws[slot * rows + threadIdx.x] = part[wide::kRows * kPanel + threadIdx.x];
    l_ws[slot * rows + threadIdx.x] = part[wide::kRows * kPanel + wide::kRows + threadIdx.x];
  }
}

// Split-KV, second pass: merge the splits of one (sequence, kv head, chunk)
// and normalize, a thread per column, 256 columns apart.
template <typename TQ>
__global__ void __launch_bounds__(wide::kThreads) combine_wide_kernel(
    const float* __restrict__ m_ws, const float* __restrict__ l_ws,
    const float* __restrict__ acc_ws, TQ* __restrict__ out, int n_q, int group, int n_splits,
    int hd, int rows) {
  const int b = blockIdx.x;
  const ChunkRows c = chunk_rows(blockIdx.y, group, rows);
  const size_t part0 = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n_splits;
  for (int g = 0; g < c.n_rows; ++g) {
    float m_max = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m_max = fmaxf(m_max, m_ws[(part0 + s) * rows + g]);
    for (int col = threadIdx.x; col < hd; col += blockDim.x) {
      float l = 0.f, o = 0.f;
      if (m_max != -INFINITY) {
        for (int s = 0; s < n_splits; ++s) {
          const float m = m_ws[(part0 + s) * rows + g];
          if (m == -INFINITY) continue;  // a split with no live position
          const float w = expf(m - m_max);
          l += w * l_ws[(part0 + s) * rows + g];
          o += w * acc_ws[((part0 + s) * rows + g) * hd + col];
        }
      }
      out[(static_cast<size_t>(b) * n_q + c.row0 + g) * hd + col] =
          from_f<TQ>(l == 0.f ? 0.f : o / l);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* sl;
  void* out;
  float* m_ws;
  float* l_ws;
  float* acc_ws;
  int batch, n_q, n_kv, group, n_pages, page_size, head_dim, table_width, window;
  int cluster;   // pipelined: CTAs a cluster
  int n_splits;  // tiled: splits a (sequence, kv head, chunk, slab)
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV>
cudaError_t launch_pipelined(const Args& a) {
  constexpr int smem = static_cast<int>(wide::Smem<TKV>::bytes);
  auto kernel = paged_decode_wide_kernel<TQ, TKV>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = sm90::set_attributes(kernel, smem, attributes_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster,
                     a.n_kv * n_chunks_of(a.group, a.head_dim) * n_panels(a.head_dim), a.batch);
  cfg.blockDim = dim3(wide::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, static_cast<TQ*>(a.out), a.n_q,
      a.group, a.n_pages, a.page_size, a.table_width, a.window, a.scale, a.head_dim,
      rows_of(a.group, a.head_dim));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_tiled(const Args& a) {
  constexpr int smem = static_cast<int>(wide::Smem<TKV>::bytes);
  auto kernel = split_decode_wide_kernel<TQ, TKV>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = sm90::set_attributes(kernel, smem, attributes_set);
  if (err != cudaSuccess) return err;
  const int chunks = a.n_kv * n_chunks_of(a.group, a.head_dim);
  const int rows = rows_of(a.group, a.head_dim);
  kernel<<<dim3(a.batch, chunks * n_panels(a.head_dim), a.n_splits), wide::kThreads, smem,
           a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      a.ks, a.vs, a.bt, a.sl, a.m_ws, a.l_ws, a.acc_ws, a.n_q, a.group, a.n_pages, a.page_size,
      a.table_width, a.window, a.scale, a.head_dim, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_wide_kernel<TQ><<<dim3(a.batch, chunks), wide::kThreads, 0, a.stream>>>(
      a.m_ws, a.l_ws, a.acc_ws, static_cast<TQ*>(a.out), a.n_q, a.group, a.n_splits,
      a.head_dim, rows);
  return cudaGetLastError();
}

// The instantiation for (dtype, kv_int8): dtype (of q and out) 0 = f32, 1 =
// bf16; kv_int8 0: pages in the dtype of q, 1: int8 pages with scales.
template <bool kTiled>
cudaError_t dispatch(const Args& a, int dtype, int kv_int8) {
  if (dtype == 1) {
    return kv_int8 ? (kTiled ? launch_tiled<__nv_bfloat16, int8_t>(a)
                             : launch_pipelined<__nv_bfloat16, int8_t>(a))
                   : (kTiled ? launch_tiled<__nv_bfloat16, __nv_bfloat16>(a)
                             : launch_pipelined<__nv_bfloat16, __nv_bfloat16>(a));
  }
  if (dtype == 0) {
    return kv_int8 ? (kTiled ? launch_tiled<float, int8_t>(a) : launch_pipelined<float, int8_t>(a))
                   : (kTiled ? launch_tiled<float, float>(a) : launch_pipelined<float, float>(a));
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int head_dim, int n_q, int n_kv, int page_size, const void* k_scales,
               const void* v_scales, int kv_int8) {
  return head_dim <= kPanel || n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv < 1 ||
         page_size <= 0 || (kv_int8 && (k_scales == nullptr || v_scales == nullptr));
}

}  // namespace

// Both entry points take head_dim above 256 (narrower heads:
// paged_decode.cu, paged_decode_tiled.cu) and any n_q / n_kv (the GQA
// group). q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size,
// head_dim]; k/v scales [n_kv, n_pages, page_size, 1] f32 (int8 pages only,
// else null); block_tables [batch, table_width] int32; seq_lens [batch]
// int32; out [batch, n_q, head_dim]. window < 0: no sliding window. dtype
// (of q and out) 0 = f32, 1 = bf16; kv_int8 0: pages in the dtype of q, 1:
// int8 pages with scales. Each returns the first failing launch's
// cudaError_t.

// Pipelined: cluster = CTAs per (sequence, kv head, group chunk, slab) for
// bf16 q, a power of two up to 8 (1 for f32 q). The signature of
// kvt_paged_decode.
extern "C" int kvt_paged_decode_wide(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scales,
                                     const void* v_scales, const void* block_tables,
                                     const void* seq_lens, void* out, int batch, int n_q,
                                     int n_kv, int n_pages, int page_size, int head_dim,
                                     int table_width, int window, int cluster, float scale,
                                     int dtype, int kv_int8, void* stream) {
  if (bad_shape(head_dim, n_q, n_kv, page_size, k_scales, v_scales, kv_int8) || cluster <= 0 ||
      cluster > 8 || (cluster & (cluster - 1)) || (dtype != 1 && cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), out, nullptr, nullptr, nullptr, batch, n_q,
               n_kv, n_q / n_kv, n_pages, page_size, head_dim, table_width, window, cluster, 1,
               scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, dtype, kv_int8));
}

// Split-KV: workspace (rows = rows_of(n_q / n_kv, head_dim), chunks =
// n_chunks_of(n_q / n_kv, head_dim)): m_ws and l_ws [batch, n_kv * chunks,
// n_splits, rows] f32, acc_ws [batch, n_kv * chunks, n_splits, rows,
// head_dim] f32; n_splits per (sequence, kv head, chunk, slab). The
// signature of kvt_paged_decode_tiled.
extern "C" int kvt_paged_decode_wide_tiled(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* seq_lens, void* m_ws,
    void* l_ws, void* acc_ws, void* out, int batch, int n_q, int n_kv, int n_pages,
    int page_size, int head_dim, int table_width, int window, int n_splits, float scale,
    int dtype, int kv_int8, void* stream) {
  if (bad_shape(head_dim, n_q, n_kv, page_size, k_scales, v_scales, kv_int8) || n_splits <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), out, static_cast<float*>(m_ws),
               static_cast<float*>(l_ws), static_cast<float*>(acc_ws), batch, n_q, n_kv,
               n_q / n_kv, n_pages, page_size, head_dim, table_width, window, 1, n_splits,
               scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<true>(a, dtype, kv_int8));
}
