// Paged decoding attention at head dims above 256 for Hopper (sm_90a), both
// decode variants, both q dtypes and both page formats: `kvt_paged_decode_wide`
// (one launch per call; for bf16 q the splits of each (sequence, kv head,
// chunk) form a thread-block cluster, as in paged_decode.cu) and
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
// 3.35 TB/s) and 33.8 MB on int8 pages (10.1 us), as the flagship's 16/8
// heads of 128.
//
// bf16 q up to head dim 1,024, on bf16 or int8 pages (the pods' main path):
// the body of namespace `hw`, the Hopper decode body of
// paged_decode_sm90.cuh widened.
//  - One CTA holds every column of the head dim, so it reads each K and V
//    byte of its share of the sequence once: a call moves the bound's K/V
//    bytes (1.0x; its int8 scales once per row; q and the output once), at
//    512 and at 1,024 alike. A GQA group above hw::max_rows(hd) (4 up to
//    512, 3 up to 768, 2 above) runs in chunks that each read the pages
//    again, as below 256.
//  - A whole warp owns one token row at a time: lane l holds the KC = hd /
//    256 (rounded up) chunks of 8 columns l, l + 32, ... (16, 24 or 32
//    columns), so q and acc for the CTA's rows stay in registers (f32, q
//    pre-scaled by log2(e)/sqrt(hd)) and a warp's loads of a row are
//    contiguous, conflict-free 16-byte (bf16) or 8-byte (int8) pieces. A
//    score is a 5-step shuffle reduction, after which every lane holds it, so
//    m and l are warp-uniform. Each consumer warp takes its share of every
//    stage's tokens, up to 4 at a time between two softmax updates, and
//    keeps its own (m, l, acc) until the warps merge once at the end of the
//    range. A warp's token is a chain of dependent steps (loads, dots,
//    shuffles, exponentials), so two consumer warps a scheduler (8) hide
//    each other's latency where the registers allow (KC 2, up to 2 rows:
//    phase 21's group of 2 at 512); else 4.
//  - One producer warp and the consumer warps on a three-stage ring of 16
//    to 64 tokens (each stage under 66 KB). The producer loads the block
//    table 32 entries at a time and, where a row is a whole number of 16
//    bytes (bf16 hd % 8 == 0, int8 hd % 16 == 0), moves each page piece's K
//    and V with one bulk copy each (cp.async.bulk on the stage's "full"
//    mbarrier), the rows packed at their own byte width; other rows (a bf16
//    row of 300 is 600 bytes) go in `row_piece` pieces by its lanes into
//    slots of the row's width rounded up to 16 bytes, whose tail is zeroed
//    once. Int8 scales ride in each stage, 4 bytes a row, copied by the
//    producer's lanes (paged_decode_sm90.cuh).
//  - Splits: the pipelined kernel's cluster (up to 16 CTAs, the
//    non-portable size, so that batch 1 spreads over the card) merges the
//    ranks' partials through distributed shared memory; the tiled kernel
//    writes each split's partial to the workspace for the combine pass
//    (paged_decode_combine.cuh, which paged_decode_tiled.cu runs too).
//    A CTA of ~200 KB of shared memory fills an SM, and clusters that the
//    card cannot hold at once run in a second wave (at batch 8, 16 clusters
//    of 8 do on an H100), so ops/paged_attention.py takes the largest
//    cluster whose launch is resident at once, from the card's own count
//    (`kvt_paged_decode_wide_resident`, cudaOccupancyMaxActiveClusters).
//
// f32 q (on f32 or int8 pages), and bf16 q above head dim 1,024, keep the
// first wide body (namespace `wide`): the output cut
// into column slabs of kPanel (256) columns, one CTA (or cluster) a slab,
// each CTA walking K in panels of kPanel columns (row_copy.cuh, `n_panels`):
//  - 256 threads, one a column of the slab: acc for every query head of the
//    chunk in registers. The range is walked kChunk tokens at a time (64; 32
//    on f32 pages). Each chunk takes P + 1 tiles of kChunk x kPanel in turn
//    (P = n_panels(hd)): K's panels 0 .. P - 1, then V's panel of this slab.
//    A K panel adds its columns' share to the chunk's scores (one (query
//    head, token) pair a thread, q's panel staged beside it as f32); the V
//    tile runs the online softmax (f32, natural exponent) and P @ V. No head
//    dim is too wide: only P grows.
//  - The tiles pass through a two-stage cp.async ring, the next tile in
//    flight while one is used, rows copied in `row_piece` pieces, the
//    columns past hd and the positions outside the range or off the pool
//    zero-filled. Int8 pages: a chunk's K and V scales ride with its first K
//    panel.
// Every slab reads K again (1.5x the K/V bytes at 512), which the checking
// paths can afford.
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

#include "paged_decode_combine.cuh"  // combine::launch, the split-KV second pass
#include "paged_decode_common.cuh"  // to_f, from_f, cp_async_*, ChunkRows, rows_of
#include "paged_decode_sm90.cuh"    // sm90::set_attributes
#include "row_copy.cuh"             // kPanel, n_panels, row_piece, with_piece, copy_piece

namespace {

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

// The Hopper body for bf16 q up to head dim 1,024 (the note at the top).
namespace hw {

constexpr int kStages = 3;  // ring depth
constexpr int kMaxChunks = 4;  // 8-column chunks a lane holds: head dims up to 1,024

// Query heads a CTA holds, q and acc of each in registers (8 KC columns a
// lane): 4 at KC 2 (head dims up to 512), 3 at KC 3, 2 at KC 4. A group
// above runs in chunks as paged_decode_common.cuh's n_chunks_of and rows_of
// (which the first wide body keeps, 4 rows at every head dim above 128).
constexpr int max_rows(int head_dim) { return head_dim <= 512 ? 4 : head_dim <= 768 ? 3 : 2; }
constexpr int n_chunks(int group, int head_dim) {
  return (group + max_rows(head_dim) - 1) / max_rows(head_dim);
}
constexpr int rows(int group, int head_dim) {
  return (group + n_chunks(group, head_dim) - 1) / n_chunks(group, head_dim);
}

// TKV: __nv_bfloat16, or int8_t with f32 per-row scales. KC: 8-column
// chunks a lane holds (2, 3 or 4: head dims up to 512, 768 or 1,024). A
// stage holds K [kStage][row] then V [kStage][row] (at kTileBytes), rows at
// their byte width rounded up to 16 (at most kWidth elements), and on int8
// pages their scales [kStage] each.
template <typename TKV, int KC, int ROWS>
struct Smem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(kQuant || std::is_same<TKV, __nv_bfloat16>::value,
                "the wide Hopper body takes bf16 or int8 pages");
  static_assert(KC >= 2 && KC <= kMaxChunks, "head dims 257 to 1,024");
  static constexpr int kCols = 8 * KC;       // columns a lane holds
  static constexpr int kWidth = 32 * kCols;  // the widest head dim: 256 KC
  // Consumer warps: 8 (two a scheduler, one's loads behind the other's
  // math) where a lane's q and acc leave the registers for it (KC 2, up to
  // 2 rows), else 4; and the producer warp.
  static constexpr int kConsumerWarps = KC == 2 && ROWS <= 2 ? 8 : 4;
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;
  // Tokens a stage: each stage under 66 KB, a multiple of kTok a warp.
  static constexpr int kStage = (KC == 2 ? 32 : 16) * (kQuant ? 2 : 1);
  static constexpr int kPerWarp = kStage / kConsumerWarps;
  // Tokens a warp scores between two softmax updates.
  static constexpr int kTok = kPerWarp < 4 ? kPerWarp : 4;
  static_assert(kPerWarp % kTok == 0, "a warp's tokens tile into steps");
  static constexpr int kTileBytes = kStage * kWidth * static_cast<int>(sizeof(TKV));
  static constexpr int kScaleOffset = 2 * kTileBytes;  // K scales, then V scales
  static constexpr int kStageBytes = kScaleOffset + (kQuant ? 2 * kStage * 4 : 0);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // After the stage loop the ring holds, as floats: each consumer warp's
  // partial [warp][acc[ROWS][kWidth], m[ROWS], l[ROWS], pad to 16 bytes],
  // then the CTA's (the same layout).
  static constexpr int kPartFloats = ROWS * kWidth + ((2 * ROWS + 3) & ~3);
  static constexpr int kPartOffset = kConsumerWarps * kPartFloats * 4;  // bytes
  static_assert(kPartOffset + kPartFloats * 4 <= kRingBytes, "partials fit the ring");
  static constexpr int kBarOffset = kRingBytes;  // full[kStages], empty[kStages]
  static constexpr int bytes = kBarOffset + 2 * kStages * 8;
};

// Chunks lane, lane + 32, ... (KC of them, 8 elements each) of the row at
// `row`, as floats; the last one is zero where `last_ok` is false (it lies
// past the head dim).
template <typename TKV, int KC>
__device__ __forceinline__ void load_row(const unsigned char* row, int lane, bool last_ok,
                                         float (&x)[8 * KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    float t[8];
    if (j < KC - 1 || last_ok) {
      sm90::load_cols<TKV, 8>(row, lane + 32 * j, t);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) x[8 * j + e] = t[e];
  }
}

// Attend the ROWS query heads at q_group ([ROWS][hd], bf16; rows from
// n_rows on do not exist and read as zeros; 256 (KC - 1) < hd <= 256 KC)
// over the positions [pos0, pos_end) of one sequence and kv head, pos0
// page-aligned, masking positions below win_lo (arguments as
// sm90::attend_range). Every thread of the CTA (kThreads) must call it. On
// return (after a CTA barrier) the CTA's partial lies in shared memory at
// the returned pointer: acc[ROWS][kWidth] (unnormalized; columns from hd on
// meaningless), m[ROWS] (log2 domain; -inf where nothing was attended),
// l[ROWS].
template <typename TKV, int KC, int ROWS>
__device__ __forceinline__ const float* attend_range(
    const __nv_bfloat16* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table, size_t head_page0,
    int n_pages, int page_size, int pos0, int pos_end, int win_lo, float scale_log2,
    int n_rows, int hd) {
  using SM = Smem<TKV, KC, ROWS>;
  constexpr bool kQuant = SM::kQuant;
  constexpr int kCols = SM::kCols;
  constexpr int kWidth = SM::kWidth;
  constexpr int kStage = SM::kStage;
  constexpr int kTok = SM::kTok;
  constexpr int kConsumerWarps = SM::kConsumerWarps;
  constexpr int kThreads = SM::kThreads;
  using sm90::mbar_arrive;
  using sm90::mbar_wait;

  extern __shared__ __align__(128) unsigned char hw_smem[];
  unsigned char* smem = hw_smem;
  const uint32_t ring = sm90::smem_u32(smem);
  const uint32_t full0 = ring + SM::kBarOffset;
  const uint32_t empty0 = full0 + 8 * kStages;
  float* scratch = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + SM::kPartOffset);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  const bool bulk = row_bytes % 16 == 0;       // a page piece is one bulk copy
  const int stride = (row_bytes + 15) & ~15;   // ring row, bytes
  const int n_stages = pos_end > pos0 ? (pos_end - pos0 + kStage - 1) / kStage : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's elected lane; on int8 pages and for rows copied in
      // pieces every producer lane, once its copies have landed.
      sm90::mbar_init(full0 + 8 * s, kQuant || !bulk ? 32 : 1);
      sm90::mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!bulk) {
    // Zero each ring row's tail past its bytes (K and V of every stage):
    // no copy writes it, and the last chunk of a lane may read it.
    for (int r = tid; r < kStages * 2 * kStage; r += kThreads) {
      unsigned char* row = smem + (r / (2 * kStage)) * SM::kStageBytes +
                           (r % (2 * kStage) >= kStage ? SM::kTileBytes : 0) +
                           (r % kStage) * stride;
      for (int b = row_bytes; b < stride; ++b) row[b] = 0;
    }
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer. Lane j holds table entry tbl_base + j; a page outside the
    // window of 32 reloads it (warp-uniform: every lane walks every page).
    [[maybe_unused]] const int half = lane >> 4;  // int8 scales: K or V
    [[maybe_unused]] const int hl = lane & 15;
    const int lo_page = pos0 / page_size;
    const int hi_page = (pos_end + page_size - 1) / page_size;
    int tbl_base = lo_page;
    int tbl = lo_page + lane < hi_page ? table[lo_page + lane] : -1;
    for (int c = 0; c < n_stages; ++c) {
      const int slot = c % kStages;
      const uint32_t full = full0 + 8 * slot;
      if (c >= kStages) mbar_wait(empty0 + 8 * slot, ((c / kStages) & 1) ^ 1);
      const int s_start = pos0 + c * kStage;
      const int s_end = min(s_start + kStage, pos_end);
      const uint32_t k_dst = ring + slot * SM::kStageBytes;
      for (int p = s_start / page_size; p * page_size < s_end; ++p) {
        if (p - tbl_base >= 32) {
          tbl_base = p;
          tbl = p + lane < hi_page ? table[p + lane] : -1;
        }
        const int page = __shfl_sync(0xffffffffu, tbl, p - tbl_base);
        if (page < 0 || page >= n_pages) continue;  // never read a row off the pool
        const int r0 = max(s_start, p * page_size);
        const int r1 = min(s_end, (p + 1) * page_size);
        const size_t row = (head_page0 + page) * page_size + (r0 - p * page_size);
        const uint32_t dst = k_dst + (r0 - s_start) * stride;
        const unsigned char* k_src = reinterpret_cast<const unsigned char*>(k_pages) + row * row_bytes;
        const unsigned char* v_src = reinterpret_cast<const unsigned char*>(v_pages) + row * row_bytes;
        if (bulk) {
          if (lane == 0) {
            const uint32_t bytes = (r1 - r0) * row_bytes;
            sm90::mbar_expect_tx(full, 2 * bytes);
            sm90::bulk_copy(dst, k_src, bytes, full);
            sm90::bulk_copy(dst + SM::kTileBytes, v_src, bytes, full);
          }
        } else {
          unsigned char* k_row = smem + (dst - ring);
          with_piece<sizeof(TKV)>(row_bytes, [&](auto piece) {
            sm90::copy_rows<decltype(piece)::value>(k_row, k_src, v_src, r1 - r0, row_bytes,
                                                    stride, SM::kTileBytes, lane);
          });
        }
        if constexpr (kQuant) {
          // Lanes 0-15 copy the K scales of the piece's rows, 16-31 the V's.
          const float* src = (half ? v_scales : k_scales) + row;
          const uint32_t sdst = k_dst + SM::kScaleOffset + half * kStage * 4 + (r0 - s_start) * 4;
          for (int i = hl; i < r1 - r0; i += 16) sm90::copy4(sdst + 4 * i, src + i);
        }
      }
      if (!bulk) {
        if (row_piece(row_bytes) < 4) {
          // Plain stores: this lane's scale copies land first, then its
          // arrival publishes both.
          sm90::cp_async_wait_all();
          mbar_arrive(full);
        } else {
          sm90::copy4_arrive(full);
        }
      } else if (kQuant) {
        sm90::copy4_arrive(full);
      } else if (lane == 0) {
        mbar_arrive(full);
      }
    }
  }

  // Consumers (the producer warp runs this part with nothing to do). Lane
  // `lane` holds columns 8 (lane + 32 j) + e, j < KC, e < 8.
  const bool last_ok = 8 * (lane + 32 * (KC - 1)) < hd;
  float q[ROWS][kCols];
  float acc[ROWS][kCols];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int col = 8 * (lane + 32 * (e / 8)) + e % 8;
      const float x = g < n_rows && col < hd ? __bfloat162float(q_group[g * hd + col]) : 0.f;
      q[g][e] = x * scale_log2;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  if (warp < kConsumerWarps) {
    for (int c = 0; c < n_stages; ++c) {
      const int slot = c % kStages;
      const int s_start = pos0 + c * kStage;
      const int n_valid = min(kStage, pos_end - s_start);
      const bool masked = n_valid < kStage || s_start < win_lo;
      const unsigned char* kt = smem + slot * SM::kStageBytes;
      const unsigned char* vt = kt + SM::kTileBytes;
      const float* k_sc = reinterpret_cast<const float*>(kt + SM::kScaleOffset);
      const float* v_sc = k_sc + kStage;
      const int t_warp = warp * SM::kPerWarp;
      mbar_wait(full0 + 8 * slot, (c / kStages) & 1);

#pragma unroll 1
      for (int i0 = 0; i0 < SM::kPerWarp; i0 += kTok) {
        float s[kTok][ROWS];
        bool live[kTok];
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          const int t = t_warp + i0 + j;
          live[j] = !masked || (t < n_valid && s_start + t >= win_lo);
          float k[kCols];
          if (live[j]) {
            load_row<TKV, KC>(kt + t * stride, lane, last_ok, k);
          } else {
#pragma unroll
            for (int e = 0; e < kCols; ++e) k[e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < ROWS; ++g) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < kCols; ++e) d = fmaf(q[g][e], k[e], d);
            s[j][g] = d;
          }
        }
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          // A live row's K scale (a masked row's slot may hold a stale NaN).
          const float k_scale = kQuant && live[j] ? k_sc[t_warp + i0 + j] : 1.f;
#pragma unroll
          for (int g = 0; g < ROWS; ++g) {
#pragma unroll
            for (int o = 16; o; o >>= 1) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
            s[j][g] = live[j] ? (kQuant ? s[j][g] * k_scale : s[j][g]) : -INFINITY;
          }
        }
        // Online softmax: every lane holds every score, so m and l are
        // warp-uniform.
#pragma unroll
        for (int g = 0; g < ROWS; ++g) {
          float mx = s[0][g];
#pragma unroll
          for (int j = 1; j < kTok; ++j) mx = fmaxf(mx, s[j][g]);
          const float m_new = fmaxf(m[g], mx);
          // A row with nothing live yet keeps m == -inf; exp2(-inf - -inf)
          // would be NaN, so its rescale and probabilities stay 0.
          const float base = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m[g] - base);
          m[g] = m_new;
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int j = 0; j < kTok; ++j) {
            s[j][g] = exp2f(s[j][g] - base);
            l[g] += s[j][g];
          }
        }
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          if (!live[j]) continue;
          const int t = t_warp + i0 + j;
          const float v_scale = kQuant ? v_sc[t] : 1.f;
          float v[kCols];
          load_row<TKV, KC>(vt + t * stride, lane, last_ok, v);
#pragma unroll
          for (int g = 0; g < ROWS; ++g) {
            const float p = kQuant ? s[j][g] * v_scale : s[j][g];
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
  }
  __syncthreads();  // the ring is free: every stage was consumed

  // Merge the warps.
  if (warp < kConsumerWarps) {
    float* mine = scratch + warp * SM::kPartFloats;
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      if (lane == 0) {
        mine[ROWS * kWidth + g] = m[g];
        mine[ROWS * kWidth + ROWS + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float4* dst = reinterpret_cast<float4*>(mine + g * kWidth + 8 * (lane + 32 * j));
        dst[0] = make_float4(acc[g][8 * j], acc[g][8 * j + 1], acc[g][8 * j + 2], acc[g][8 * j + 3]);
        dst[1] = make_float4(acc[g][8 * j + 4], acc[g][8 * j + 5], acc[g][8 * j + 6],
                             acc[g][8 * j + 7]);
      }
    }
  }
  __syncthreads();
  for (int col = tid; col < kWidth; col += kThreads) {
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        mm = fmaxf(mm, scratch[w * SM::kPartFloats + ROWS * kWidth + g]);
      }
      float ll = 0.f, a = 0.f;
      if (mm != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          const float* pw = scratch + w * SM::kPartFloats;
          const float mw = pw[ROWS * kWidth + g];
          if (mw == -INFINITY) continue;  // a warp with nothing live
          const float f = exp2f(mw - mm);
          ll = fmaf(f, pw[ROWS * kWidth + ROWS + g], ll);
          a = fmaf(f, pw[g * kWidth + col], a);
        }
      }
      part[g * kWidth + col] = a;
      if (col == 0) {
        part[ROWS * kWidth + g] = mm;
        part[ROWS * kWidth + ROWS + g] = ll;
      }
    }
  }
  __syncthreads();
  return part;
}

// launch(std::integral_constant<int, KC>, std::integral_constant<int, ROWS>)
// for the instantiation that serves head_dim (KC = n_panels(head_dim)) and
// a chunk of `rows` query heads: ROWS 2 or 4 at KC 2, 3 at KC 3, 2 at KC 4
// (max_rows), the chunk's rows passed at run time.
template <typename F>
cudaError_t with_shape(int head_dim, int rows, F&& launch) {
  using std::integral_constant;
  switch (n_panels(head_dim)) {
    case 2:
      return rows <= 2 ? launch(integral_constant<int, 2>{}, integral_constant<int, 2>{})
                       : launch(integral_constant<int, 2>{}, integral_constant<int, 4>{});
    case 3: return launch(integral_constant<int, 3>{}, integral_constant<int, 3>{});
    case 4: return launch(integral_constant<int, 4>{}, integral_constant<int, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hw

// The first wide body's kernels (f32 q; bf16 q above head dim 1,024).
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

// The Hopper body's kernels (bf16 q up to head dim 1,024). Pipelined:
// rank blockIdx.x of the cluster of (sequence blockIdx.z; kv head and chunk
// blockIdx.y) attends over its share of the live pages for every column;
// after a cluster barrier each rank merges kWidth / cluster columns from
// every rank through distributed shared memory, in rank order, and writes
// the normalized output; a second barrier keeps every CTA's shared memory
// alive until its peers have read it. A rank with no live page still
// reaches both barriers (m = -inf, l = 0).
template <typename TKV, int KC, int ROWS>
__global__ void __launch_bounds__((hw::Smem<TKV, KC, ROWS>::kThreads), 1) paged_decode_hw_kernel(
    const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int n_q, int group,
    int n_pages, int page_size, int table_width, int window, float scale_log2, int hd,
    int rows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const ChunkRows c = chunk_rows(blockIdx.y, group, rows);
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

  const float* part = hw::attend_range<TKV, KC, ROWS>(
      q + q0, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width, static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo,
      scale_log2, c.n_rows, hd);

  cluster.sync();  // every rank's partial is in its shared memory
  // Each rank merges kWidth / n_ranks columns (the cluster, a power of two
  // up to 16, divides 512, 768 and 1,024) and writes those below hd.
  constexpr int W = hw::Smem<TKV, KC, ROWS>::kWidth;
  const int cols = W / n_ranks;
  for (int i = threadIdx.x; i < c.n_rows * cols; i += blockDim.x) {
    const int g = i / cols;
    const int col = rank * cols + i % cols;
    float mm = -INFINITY;
    for (int r = 0; r < n_ranks; ++r) {
      mm = fmaxf(mm, cluster.map_shared_rank(part, r)[ROWS * W + g]);
    }
    float ll = 0.f, a = 0.f;
    if (mm != -INFINITY) {
      for (int r = 0; r < n_ranks; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float mr = pr[ROWS * W + g];
        if (mr == -INFINITY) continue;  // a rank with no live position
        const float f = exp2f(mr - mm);
        ll = fmaf(f, pr[ROWS * W + ROWS + g], ll);
        a = fmaf(f, pr[g * W + col], a);
      }
    }
    if (col < hd) out[q0 + g * hd + col] = __float2bfloat16(ll == 0.f ? 0.f : a / ll);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

// Split-KV, first pass, on the Hopper body: the partial of one (sequence,
// kv head, chunk) over one split of its pages, every column, into the
// workspace of split_decode_wide_kernel (m in the natural-log domain, as
// the combine pass takes it).
template <typename TKV, int KC, int ROWS>
__global__ void __launch_bounds__((hw::Smem<TKV, KC, ROWS>::kThreads), 1) split_decode_hw_kernel(
    const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, float* __restrict__ m_ws, float* __restrict__ l_ws,
    float* __restrict__ acc_ws, int n_q, int group, int n_pages, int page_size,
    int table_width, int window, float scale_log2, int hd, int rows) {
  const int b = blockIdx.x;
  const ChunkRows c = chunk_rows(blockIdx.y, group, rows);
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

  const float* part = hw::attend_range<TKV, KC, ROWS>(
      q + (static_cast<size_t>(b) * n_q + c.row0) * hd, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width, static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo,
      scale_log2, c.n_rows, hd);

  constexpr int W = hw::Smem<TKV, KC, ROWS>::kWidth;
  const size_t slot = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n_splits + split;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int col = i % W;
    if (col < hd) acc_ws[(slot * rows + i / W) * hd + col] = part[i / W * W + col];
  }
  if (static_cast<int>(threadIdx.x) < rows) {
    const float m = part[ROWS * W + threadIdx.x];
    m_ws[slot * rows + threadIdx.x] = m == -INFINITY ? m : m * sm90::kLn2;
    l_ws[slot * rows + threadIdx.x] = part[ROWS * W + ROWS + threadIdx.x];
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
  int n_splits;  // tiled: splits a (sequence, kv head, chunk[, slab])
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
  return combine::launch(a.m_ws, a.l_ws, a.acc_ws, static_cast<TQ*>(a.out), a.batch, a.n_q,
                         a.group, a.n_splits, a.head_dim, rows, a.stream);
}

// The Hopper body's attributes, once per device and instantiation (as
// sm90::set_attributes): its dynamic shared memory, and clusters above the
// portable 8 CTAs.
template <typename Kernel>
cudaError_t set_hw_attributes(Kernel kernel, int smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename TKV, int KC, int ROWS>
cudaError_t launch_hw_pipelined(const Args& a) {
  constexpr int smem = hw::Smem<TKV, KC, ROWS>::bytes;
  auto kernel = paged_decode_hw_kernel<TKV, KC, ROWS>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = set_hw_attributes(kernel, smem, attributes_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.n_kv * hw::n_chunks(a.group, a.head_dim), a.batch);
  cfg.blockDim = dim3(hw::Smem<TKV, KC, ROWS>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, static_cast<__nv_bfloat16*>(a.out),
      a.n_q, a.group, a.n_pages, a.page_size, a.table_width, a.window,
      a.scale * 1.4426950408889634f, a.head_dim, hw::rows(a.group, a.head_dim));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TKV, int KC, int ROWS>
cudaError_t launch_hw_tiled(const Args& a) {
  constexpr int smem = hw::Smem<TKV, KC, ROWS>::bytes;
  auto kernel = split_decode_hw_kernel<TKV, KC, ROWS>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = sm90::set_attributes(kernel, smem, attributes_set);
  if (err != cudaSuccess) return err;
  const int chunks = a.n_kv * hw::n_chunks(a.group, a.head_dim);
  const int rows = hw::rows(a.group, a.head_dim);
  kernel<<<dim3(a.batch, chunks, a.n_splits), hw::Smem<TKV, KC, ROWS>::kThreads, smem,
           a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, a.m_ws, a.l_ws, a.acc_ws, a.n_q,
      a.group, a.n_pages, a.page_size, a.table_width, a.window, a.scale * 1.4426950408889634f,
      a.head_dim, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine::launch(a.m_ws, a.l_ws, a.acc_ws, static_cast<__nv_bfloat16*>(a.out), a.batch,
                         a.n_q, a.group, a.n_splits, a.head_dim, rows, a.stream);
}

// Clusters of `cluster` CTAs of the pipelined Hopper-body kernel that the
// current device holds at once.
template <typename TKV, int KC, int ROWS>
cudaError_t resident_clusters(int cluster, int* n) {
  using SM = hw::Smem<TKV, KC, ROWS>;
  auto kernel = paged_decode_hw_kernel<TKV, KC, ROWS>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = set_hw_attributes(kernel, SM::bytes, attributes_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(SM::kThreads);
  cfg.dynamicSmemBytes = SM::bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// bf16 q up to head dim 1,024 runs the Hopper body; f32 q, and bf16 q
// above, the first wide body.
bool hopper_body(int head_dim, int dtype) {
  return dtype == 1 && head_dim <= 256 * hw::kMaxChunks;
}

// The instantiation for (dtype, kv_int8): dtype (of q and out) 0 = f32, 1 =
// bf16; kv_int8 0: pages in the dtype of q, 1: int8 pages with scales.
template <bool kTiled>
cudaError_t dispatch(const Args& a, int dtype, int kv_int8) {
  if (hopper_body(a.head_dim, dtype)) {
    return hw::with_shape(a.head_dim, hw::rows(a.group, a.head_dim), [&](auto kc, auto rows) {
      constexpr int KC = decltype(kc)::value;
      constexpr int ROWS = decltype(rows)::value;
      return kv_int8 ? (kTiled ? launch_hw_tiled<int8_t, KC, ROWS>(a)
                               : launch_hw_pipelined<int8_t, KC, ROWS>(a))
                     : (kTiled ? launch_hw_tiled<__nv_bfloat16, KC, ROWS>(a)
                               : launch_hw_pipelined<__nv_bfloat16, KC, ROWS>(a));
    });
  }
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

// Pipelined: cluster = CTAs per (sequence, kv head, group chunk) for bf16
// q, a power of two up to 16 (up to 8 above head dim 1,024, a cluster per
// slab; 1 for f32 q). The signature of kvt_paged_decode.
extern "C" int kvt_paged_decode_wide(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scales,
                                     const void* v_scales, const void* block_tables,
                                     const void* seq_lens, void* out, int batch, int n_q,
                                     int n_kv, int n_pages, int page_size, int head_dim,
                                     int table_width, int window, int cluster, float scale,
                                     int dtype, int kv_int8, void* stream) {
  if (bad_shape(head_dim, n_q, n_kv, page_size, k_scales, v_scales, kv_int8) || cluster <= 0 ||
      cluster > (hopper_body(head_dim, dtype) ? 16 : 8) || (cluster & (cluster - 1)) ||
      (dtype != 1 && cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), out, nullptr, nullptr, nullptr, batch, n_q,
               n_kv, n_q / n_kv, n_pages, page_size, head_dim, table_width, window, cluster, 1,
               scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<false>(a, dtype, kv_int8));
}

// Split-KV: workspace (rows = hw::rows(n_q / n_kv, head_dim) and chunks =
// hw::n_chunks(...) where the Hopper body runs, rows_of and n_chunks_of
// where the first wide body does): m_ws and l_ws [batch, n_kv * chunks,
// n_splits, rows] f32, acc_ws [batch, n_kv * chunks, n_splits, rows,
// head_dim] f32; n_splits per (sequence, kv head, chunk), and per slab
// where the first wide body runs. The signature of kvt_paged_decode_tiled.
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

// The clusters of `cluster` CTAs (1 to 16) of kvt_paged_decode_wide's
// pipelined kernel for bf16 q at head_dim (257 to 1,024), GQA group `group`
// and page format kv_int8 that the current device holds at once
// (cudaOccupancyMaxActiveClusters): ops/paged_attention.py sizes its
// clusters so that every one is resident. 0 for another shape or a failed
// query.
extern "C" int kvt_paged_decode_wide_resident(int head_dim, int group, int kv_int8,
                                              int cluster) {
  if (head_dim <= kPanel || !hopper_body(head_dim, 1) || group < 1 || cluster < 1 ||
      cluster > 16) {
    return 0;
  }
  int n = 0;
  const cudaError_t err =
      hw::with_shape(head_dim, hw::rows(group, head_dim), [&](auto kc, auto rows) {
        constexpr int KC = decltype(kc)::value;
        constexpr int ROWS = decltype(rows)::value;
        return kv_int8 ? resident_clusters<int8_t, KC, ROWS>(cluster, &n)
                       : resident_clusters<__nv_bfloat16, KC, ROWS>(cluster, &n);
      });
  return err == cudaSuccess ? n : 0;
}
