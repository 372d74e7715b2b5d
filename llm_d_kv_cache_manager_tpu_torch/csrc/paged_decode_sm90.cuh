// The Hopper attention body of the two paged-decode kernels, for bf16 q on
// bf16 pages and for f32 q on f32 pages, each also on int8 pages with f32
// per-row scales (paged_decode.cu: the splits of one (sequence, kv head) form
// a thread-block cluster; paged_decode_tiled.cu: one CTA per (sequence, kv
// head, split)): one query token's GQA group attends over a contiguous range
// of one sequence's positions and leaves its partial softmax state in shared
// memory. A CTA holds ROWS query heads of one kv head: the whole GQA group,
// or one chunk of a group above 8 (paged_decode_common.cuh, `rows_of`).
//
// Every decode up to head_dim 256 runs here, for either q dtype. Both serve
// the TPU kernels `_decode_kernel_pipelined` and `_decode_kernel` of the
// reference package (llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157
// and :78), the int8 pages those kernels' `quantized=True` instantiations
// (dequantized in f32, as there: :118-121 and :247-250).
//
// Bound on this card: bytes. Every K and V row of every live position is read
// once and used for 2 * group FLOPs per element, far below the ~295 FLOP/byte
// at which an H100 turns compute-bound, so tensor cores buy nothing; what
// counts is bytes in flight and a cheap inner loop. At batch 8 x 2,048 tokens,
// 8 kv heads of 128, one layer call moves 67.2 MB on bf16 pages (20.0 us at
// 3.35 TB/s), 134.2 MB on f32 pages (40.1 us) and 34.7 MB on int8 pages
// (10.4 us). Head dim 64 halves the bytes of a row, and the body's work per
// row with them.
//
// What the first port's body lost, and where: four
// __syncthreads per 64-token chunk; scores written to shared memory and read
// back for the softmax and again for P @ V; each (group row, token) dot read
// q as f32 from shared memory, 512 bytes beside the 256-byte K row; a ring
// two stages deep; and every 16-byte copy recomputed `table[pos / page]`
// from device memory with an integer division.
//
// This body:
//  - One producer warp and four consumer warps. The producer loads the CTA's
//    block-table entries 32 at a time (one coalesced load, then shuffles) and
//    moves each stage with Hopper's bulk copy
//    (cp.async.bulk ... mbarrier::complete_tx), one copy of K and one of V
//    per page piece (4 KB at page 16 in bf16 at head_dim 128, half a page at
//    page 128), into a three-stage ring. A stage holds `stage_tokens` (64,
//    or 32 for f32 rows of 128 and 256 columns), so a stage of K and V is 32
//    KB up to head_dim 128 and 64 KB at 256 on bf16 and f32 pages alike
//    (16.5 KB on int8 pages at 128), and three stages fit shared memory at
//    every width. Each stage has a "full" mbarrier (the copies' bytes) and an
//    "empty" one (one arrival per consumer warp); no thread of the CTA waits
//    for another except through them.
//  - The math is in registers. A half-warp owns one token row at a time:
//    lane i reads the kCols = HD / 16 columns from kCols * i onwards. At
//    head_dim 128 that is 32 bytes (8 f32), 16 bytes (8 bf16) or 8 bytes (8
//    int8) a lane, in 16-byte loads where it is 16 bytes or more. q for the
//    CTA's rows sits in registers as f32 (either q dtype), pre-scaled by
//    log2(e)/sqrt(head_dim), so scores are in the exp2 domain; a score is a
//    4-step shuffle reduction inside the half-warp. Each warp takes a quarter
//    of every stage and keeps its own (m, l) per row and its own acc (kCols
//    columns x rows), P @ V accumulating in the lanes that read V. No score
//    buffer, no per-token barrier. The output is written in q's dtype.
//  - Int8 pages: a row's f32 scale stays out of the inner products (score =
//    k_scale * sum(q * k), and p * v_scale enters P @ V), one multiply per
//    token row. An int8 element becomes f32 through a byte permute into the
//    mantissa of 2^23 and one subtraction (the converter instruction runs at
//    a quarter of the FMA rate). The scales need not be 16-byte aligned, so
//    they do not ride the bulk copies: the producer's lanes copy them, 4
//    bytes each (cp.async), into the stage, and each lane's
//    cp.async.mbarrier.arrive holds the stage's "full" barrier until its
//    copies land. Any page size works.
//  - Only a stage that holds a position outside [win_lo, pos_end) builds a
//    mask (the first stage under a window, the range's last stage); the
//    others take the unmasked path. Masked positions, their values and their
//    scales, are never read, so a stale row in the ring cannot leak a NaN.
//  - Warps merge their (m, l, acc) once, at the end of the range, through
//    shared memory (the ring, free by then).
//
// Head dims: the body is built at the padded widths 64, 128 and 256 (HD);
// the true head dim (hd) comes at run time. At hd == HD the rows are
// 16-byte multiples and a page piece is one bulk copy, as above: that
// instantiation (kBulk) compiles this producer alone. Below it
// (50, 80, 96, 100, ...) the pools keep their unpadded rows, whose starts
// are only 8, 4, 2 or 1-byte aligned (a bf16 row of 100 is 200 bytes, an
// int8 one 100), so no bulk copy may start or end there: the producer's
// lanes copy each row of the piece into its padded slot in pieces of the
// largest size its byte width allows (`row_piece`: 16, 8 or 4 bytes by
// cp.async, each lane then arriving on the stage's "full" barrier through
// cp.async.mbarrier.arrive; 2 or 1 by plain loads, the lane arriving after
// them). The padded columns of every ring row are zeroed once, before the
// first stage, and no copy writes them; q's padded columns are zero, so
// they add nothing to a score, and only the true columns are written out.
// At HD 256 a lane holds 16 columns, so a CTA takes at most 4 query heads
// (`max_rows_of`) and one CTA fills an SM on bf16 and f32 pages (a 192 KB
// ring).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "paged_decode_common.cuh"  // to_f
#include "row_copy.cuh"               // row_piece, with_piece, copy_piece

namespace sm90 {

constexpr int kStages = 3;          // ring depth, at every page format and width
constexpr int kConsumerWarps = 4;   // each takes a quarter of a stage
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr float kLn2 = 0.6931471805599453f;

// Tokens a ring stage holds, kStageTokens[page format][padded width]: formats
// int8, bf16, f32 (`format_of`), widths 64, 128, 256. A 64-token stage of K
// and V is at most 64 KB, but for f32 rows of 128 and 256 columns (64 and
// 128 KB), which take 32 tokens: so three stages fit at every width, and a
// stage's bytes at 128 and 256 are bf16's. ops/paged_attention.py's
// STAGE_TOKENS mirrors this table (a tier-1 test holds the two equal), for
// decode_plan's cap.
constexpr int kStageTokens[3][3] = {
    {64, 64, 64},  // int8
    {64, 64, 64},  // bf16
    {64, 32, 32},  // f32
};
template <typename TKV>
constexpr int format_of() {
  return std::is_same<TKV, int8_t>::value ? 0 : std::is_same<TKV, __nv_bfloat16>::value ? 1 : 2;
}

// TKV: __nv_bfloat16, float, or int8_t with f32 per-row scales. A stage
// holds K [kStage][HD], V [kStage][HD] and, on int8 pages, their scales
// [kStage] each.
template <typename TKV, int HD, int ROWS>
struct Smem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(kQuant || std::is_same<TKV, __nv_bfloat16>::value ||
                    std::is_same<TKV, float>::value,
                "the sm90 decode body takes bf16, f32 or int8 pages");
  // A half-warp covers one row, HD / 16 columns a lane: 4, 8 or 16, vector
  // loads of 4 to 64 bytes on any page format.
  static_assert(HD == 64 || HD == 128 || HD == 256,
                "the sm90 decode body is built at head_dim 64, 128 or 256");
  static constexpr int kStage = kStageTokens[format_of<TKV>()][HD == 64 ? 0 : HD == 128 ? 1 : 2];
  static constexpr int kTokPerHalf = kStage / kConsumerWarps / 2;  // rows a half-warp a stage
  static constexpr int kCols = HD / 16;
  static constexpr int kRowBytes = HD * sizeof(TKV);
  static constexpr int kTileBytes = kStage * kRowBytes;  // one stage's K (or V)
  static constexpr int kScaleOffset = 2 * kTileBytes;    // K scales, then V scales
  static constexpr int kStageBytes = kScaleOffset + (kQuant ? 2 * kStage * 4 : 0);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // After the stage loop the ring holds, as floats: each consumer warp's
  // partial [warp][acc[G][HD], m[G], l[G], pad to 16 bytes], then the CTA's
  // (the same layout).
  static constexpr int kPartFloats = ROWS * HD + ((2 * ROWS + 3) & ~3);
  static constexpr int kPartOffset = kConsumerWarps * kPartFloats * 4;  // bytes
  static_assert(kPartOffset + kPartFloats * 4 <= kRingBytes, "partials fit the ring");
  static constexpr int kBarOffset = kRingBytes;  // full[kStages], empty[kStages]
  static constexpr int bytes = kBarOffset + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void copy4_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W words of f32 -> W floats.
template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W], float (&x)[W], float) {
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = __uint_as_float(w[i]);
}

// W words of bf16 pairs -> 2W floats.
template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W], float (&x)[2 * W],
                                       __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// W words of int8 quads -> 4W exact floats: b + 128 (the xor) becomes the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W], float (&x)[4 * W], int8_t) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      x[4 * i + b] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) - 8388736.f;
    }
  }
}

// Columns N hl .. N hl + N - 1 of the row at `row` (type T: f32, bf16 or
// int8), as floats: vector loads of 4 or 8 bytes, or 1 to 4 of 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_cols(const void* row, int hl, float (&x)[N]) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4 || kWords == 8 || kWords == 16,
                "a lane loads 4, 8, 16, 32 or 64 bytes");
  const unsigned char* p = static_cast<const unsigned char*>(row) + hl * kWords * 4;
  uint32_t w[kWords];
  if constexpr (kWords >= 4) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = r.x, w[4 * i + 1] = r.y, w[4 * i + 2] = r.z, w[4 * i + 3] = r.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x, w[1] = r.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  unpack(w, x, T{});
}

// Rows [0, n) of K and V, `row_bytes` each and contiguous at k_src and
// v_src, into their padded ring slots at k_row (`slot_bytes` apart, V
// `tile_bytes` after K): lane l copies pieces l, l + 32, ... of G bytes of
// every row, so a warp's copies cover a row's bytes side by side.
template <int G>
__device__ __forceinline__ void copy_rows(unsigned char* k_row, const unsigned char* k_src,
                                       const unsigned char* v_src, int n, int row_bytes,
                                       int slot_bytes, int tile_bytes, int lane) {
  for (int off = lane * G; off < row_bytes; off += 32 * G) {
    for (int r = 0; r < n; ++r) {
      copy_piece<G>(k_row + r * slot_bytes + off, k_src + r * row_bytes + off);
      copy_piece<G>(k_row + tile_bytes + r * slot_bytes + off, v_src + r * row_bytes + off);
    }
  }
}

// Kernel attributes belong to the current device's context: set the
// dynamic shared memory size once per device and instantiation (`done`, the
// caller's function-local static, holds bit d for device d; devices past 31
// are set on every launch).
template <typename Kernel>
cudaError_t set_attributes(Kernel kernel, int smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Attend the ROWS query heads at q_group ([ROWS][hd], type TQ; rows from
// n_rows on do not exist and read as zeros; hd <= HD, the padded width)
// over the positions [pos0, pos_end) of one sequence and kv head, pos0
// page-aligned, masking positions below win_lo. `table`: the sequence's block-table row;
// `head_page0`: h * n_pages; `k_scales`/`v_scales`: the int8 pools' f32 row
// scales ([n_kv, n_pages, page], unused on bf16 and f32 pages). TQ: bf16
// (on bf16 or int8 pages) or float (on f32 or int8 pages). Every thread of the
// CTA (kThreads) must call it. On return (after a CTA barrier) the CTA's
// partial lies in shared memory at the returned pointer: acc[ROWS][HD]
// (unnormalized; columns from hd on meaningless), m[ROWS] (log2 domain;
// -inf where nothing was attended), l[ROWS]. kBulk: hd == HD, whose rows
// are whole 16-byte multiples laid out as in the ring, so a page piece is
// one bulk copy; the caller picks the instantiation from hd.
template <typename TQ, typename TKV, int HD, int ROWS, bool kBulk>
__device__ __forceinline__ const float* attend_range(
    const TQ* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table, size_t head_page0,
    int n_pages, int page_size, int pos0, int pos_end, int win_lo, float scale_log2,
    int n_rows, int hd) {
  using SM = Smem<TKV, HD, ROWS>;
  constexpr bool kQuant = SM::kQuant;
  constexpr int kCols = SM::kCols;
  constexpr int kStage = SM::kStage;
  constexpr int kTokPerHalf = SM::kTokPerHalf;
  static_assert(std::is_same<TQ, __nv_bfloat16>::value || std::is_same<TQ, float>::value,
                "q is bf16 or f32");
  static_assert(kQuant || std::is_same<TQ, TKV>::value, "pages in q's dtype, or int8");
  // Tokens per half-warp between two softmax updates: scores s[kTok][ROWS]
  // stay within 16 registers.
  constexpr int kTokWanted = ROWS > 4 ? 2 : (ROWS > 2 ? 4 : 8);
  constexpr int kTok = kTokWanted < kTokPerHalf ? kTokWanted : kTokPerHalf;
  static_assert(kTokPerHalf % kTok == 0, "steps tile a stage");

  // (Named apart from the combine's array, which paged_decode_tiled.cu
  // declares with another type.)
  extern __shared__ __align__(128) unsigned char ring_smem[];
  unsigned char* smem = ring_smem;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + SM::kBarOffset;
  const uint32_t empty0 = full0 + 8 * kStages;
  float* scratch = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + SM::kPartOffset);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  [[maybe_unused]] const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  const int n_stages = pos_end > pos0 ? (pos_end - pos0 + kStage - 1) / kStage : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's elected lane; on int8 pages and for rows copied in
      // pieces every producer lane, once its copies have landed.
      mbar_init(full0 + 8 * s, kQuant || !kBulk ? 32 : 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kBulk) {
    // Zero the padded columns of every ring row (K and V of every stage),
    // 4 bytes at a time: no copy writes them.
    const int pad_words = (SM::kRowBytes - row_bytes) / 4;
    const int lo = SM::kRowBytes / 4 - pad_words;
    for (int i = tid; i < kStages * 2 * kStage * pad_words; i += kThreads) {
      const int r = i / pad_words;  // ring row: stage, K or V, token
      const int stage = r / (2 * kStage);
      reinterpret_cast<uint32_t*>(smem + stage * SM::kStageBytes)[
          (r % (2 * kStage)) * (SM::kRowBytes / 4) + lo + i % pad_words] = 0u;
    }
    if ((row_bytes & 3) != 0) {
      // The word holding the row's last bytes: zero its part past them.
      for (int r = tid; r < kStages * 2 * kStage; r += kThreads) {
        unsigned char* row =
            smem + (r / (2 * kStage)) * SM::kStageBytes + (r % (2 * kStage)) * SM::kRowBytes;
        for (int b = row_bytes; b < ((row_bytes + 3) & ~3); ++b) row[b] = 0;
      }
    }
  }
  __syncthreads();

  const int half = lane >> 4;
  const int hl = lane & 15;  // consumers: columns kCols hl .. kCols hl + kCols - 1
  if (warp == kConsumerWarps) {
    // Producer. Lane j holds table entry tbl_base + j; a page outside the
    // window of 32 reloads it (warp-uniform: every lane walks every page).
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
        const uint32_t dst = k_dst + (r0 - s_start) * SM::kRowBytes;
        if constexpr (kBulk) {
          if (lane == 0) {
            const uint32_t bytes = (r1 - r0) * SM::kRowBytes;
            mbar_expect_tx(full, 2 * bytes);
            bulk_copy(dst, k_pages + row * HD, bytes, full);
            bulk_copy(dst + SM::kTileBytes, v_pages + row * HD, bytes, full);
          }
        } else {
          // Row by row into the padded slots.
          const unsigned char* k_src = reinterpret_cast<const unsigned char*>(k_pages + row * hd);
          const unsigned char* v_src = reinterpret_cast<const unsigned char*>(v_pages + row * hd);
          unsigned char* k_row = smem + (dst - ring);
          with_piece<sizeof(TKV)>(row_bytes, [&](auto piece) {
            copy_rows<decltype(piece)::value>(k_row, k_src, v_src, r1 - r0, row_bytes,
                                              SM::kRowBytes, SM::kTileBytes, lane);
          });
        }
        if constexpr (kQuant) {
          // Lanes 0-15 copy the K scales of the piece's rows, 16-31 the V's.
          const float* src = (half ? v_scales : k_scales) + row;
          const uint32_t sdst =
              k_dst + SM::kScaleOffset + half * kStage * 4 + (r0 - s_start) * 4;
          for (int i = hl; i < r1 - r0; i += 16) copy4(sdst + 4 * i, src + i);
        }
      }
      if constexpr (!kBulk) {
        if (row_piece(row_bytes) < 4) {
          // Plain stores: this lane's scale copies land first, then its
          // arrival publishes both.
          cp_async_wait_all();
          mbar_arrive(full);
        } else {
          copy4_arrive(full);
        }
      } else if (kQuant) {
        copy4_arrive(full);
      } else if (lane == 0) {
        mbar_arrive(full);
      }
    }
  }

  // Consumers (the producer warp runs this part with nothing to do).
  float q[ROWS][kCols];
  float acc[ROWS][kCols];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    float x[kCols];
    if (kBulk && g < n_rows) {
      load_cols<TQ, kCols>(q_group + g * HD, hl, x);
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int col = kCols * hl + e;
        x[e] = g < n_rows && col < hd ? to_f(q_group[g * hd + col]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      q[g][e] = x[e] * scale_log2;
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
      const int t_half = warp * (2 * kTokPerHalf) + half * kTokPerHalf;
      mbar_wait(full0 + 8 * slot, (c / kStages) & 1);

#pragma unroll
      for (int i0 = 0; i0 < kTokPerHalf; i0 += kTok) {
        float s[kTok][ROWS];
        bool live[kTok];
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          const int t = t_half + i0 + j;
          live[j] = !masked || (t < n_valid && s_start + t >= win_lo);
          float k[kCols];
          if (live[j]) {
            load_cols<TKV, kCols>(kt + t * SM::kRowBytes, hl, k);
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
          const float k_scale = kQuant && live[j] ? k_sc[t_half + i0 + j] : 1.f;
#pragma unroll
          for (int g = 0; g < ROWS; ++g) {
#pragma unroll
            for (int o = 8; o; o >>= 1) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
            s[j][g] = live[j] ? (kQuant ? s[j][g] * k_scale : s[j][g]) : -INFINITY;
          }
        }
        // Online softmax: m is warp-uniform; l and acc are per half-warp
        // until the end of the range.
#pragma unroll
        for (int g = 0; g < ROWS; ++g) {
          float mx = s[0][g];
#pragma unroll
          for (int j = 1; j < kTok; ++j) mx = fmaxf(mx, s[j][g]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
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
          const int t = t_half + i0 + j;
          const float v_scale = kQuant ? v_sc[t] : 1.f;
          float v[kCols];
          load_cols<TKV, kCols>(vt + t * SM::kRowBytes, hl, v);
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

  // Merge the two half-warps, then the warps.
  if (warp < kConsumerWarps) {
    float* mine = scratch + warp * SM::kPartFloats;
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      if (lane == 0) {
        mine[ROWS * HD + g] = m[g];
        mine[ROWS * HD + ROWS + g] = l[g];
      }
      if (half == 0) {
        float4* dst = reinterpret_cast<float4*>(mine + g * HD + kCols * hl);
#pragma unroll
        for (int e = 0; e < kCols; e += 4) {
          dst[e / 4] = make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
        }
      }
    }
  }
  __syncthreads();
  for (int col = tid; col < HD; col += kThreads) {
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        mm = fmaxf(mm, scratch[w * SM::kPartFloats + ROWS * HD + g]);
      }
      float ll = 0.f, a = 0.f;
      if (mm != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          const float* pw = scratch + w * SM::kPartFloats;
          const float mw = pw[ROWS * HD + g];
          if (mw == -INFINITY) continue;  // a warp with nothing live
          const float f = exp2f(mw - mm);
          ll = fmaf(f, pw[ROWS * HD + ROWS + g], ll);
          a = fmaf(f, pw[g * HD + col], a);
        }
      }
      part[g * HD + col] = a;
      if (col == 0) {
        part[ROWS * HD + g] = mm;
        part[ROWS * HD + ROWS + g] = ll;
      }
    }
  }
  __syncthreads();
  return part;
}

}  // namespace sm90
