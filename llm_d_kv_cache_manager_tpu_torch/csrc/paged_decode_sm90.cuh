// The Hopper attention body of the two paged-decode kernels for bf16 q, on
// bf16 pages and on int8 pages with f32 per-row scales (paged_decode.cu: the
// splits of one (sequence, kv head) form a thread-block cluster;
// paged_decode_tiled.cu: one CTA per (sequence, kv head, split)): one query
// token's GQA group attends over a contiguous range of one sequence's
// positions and leaves its partial softmax state in shared memory.
//
// Replaces, for bf16 q, the body of paged_decode_common.cuh (which the f32-q
// instantiations keep). Both serve the TPU kernels `_decode_kernel_pipelined`
// and `_decode_kernel` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157 and :78), the int8
// pages those kernels' `quantized=True` instantiations (dequantized in f32,
// as there: :118-121 and :247-250).
//
// Bound on this card: bytes. Every K and V row of every live position is read
// once and used for 2 * group FLOPs per element, far below the ~295 FLOP/byte
// at which an H100 turns compute-bound, so tensor cores buy nothing; what
// counts is bytes in flight and a cheap inner loop. At batch 8 x 2,048 tokens,
// 8 kv heads of 128, one layer call moves 67.2 MB on bf16 pages (20.0 us at
// 3.35 TB/s) and 34.7 MB on int8 pages (10.4 us).
//
// What the old body lost, and where (paged_decode_common.cuh): four
// __syncthreads per 64-token chunk; scores written to shared memory and read
// back for the softmax and again for P @ V; each (group row, token) dot read
// q as f32 from shared memory, 512 bytes beside the 256-byte K row; a ring
// two stages deep; and every 16-byte copy recomputed `table[pos / page]`
// from device memory with an integer division.
//
// This body:
//  - One producer warp and four consumer warps. The producer loads the CTA's
//    block-table entries 32 at a time (one coalesced load, then shuffles) and
//    moves each stage of 64 tokens with Hopper's bulk copy
//    (cp.async.bulk ... mbarrier::complete_tx), one copy of K and one of V
//    per page piece (4 KB at page 16 in bf16, half a page at page 128), into
//    a three-stage ring of 32 KB stages (16.5 KB on int8 pages). Each stage
//    has a "full" mbarrier (the copies' bytes) and an "empty" one (one
//    arrival per consumer warp); no thread of the CTA waits for another
//    except through them.
//  - The math is in registers. A half-warp owns one token row at a time:
//    lane i reads column 8i onwards, 16 bytes (8 bf16) or 8 bytes (8 int8),
//    conflict-free on the unpadded 256- or 128-byte rows. q for the whole
//    group sits in registers as f32, pre-scaled by log2(e)/sqrt(head_dim), so
//    scores are in the exp2 domain; a score is a 4-step shuffle reduction
//    inside the half-warp. Each warp takes 16 tokens of every stage and keeps
//    its own (m, l) per group row and its own acc (8 columns x group), P @ V
//    accumulating in the lanes that read V. No score buffer, no per-token
//    barrier.
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace sm90 {

constexpr int kStage = 64;          // tokens per ring stage, on either page format
constexpr int kStages = 3;          // ring depth
constexpr int kConsumerWarps = 4;   // each takes 16 tokens of a stage
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kTokPerHalf = kStage / kConsumerWarps / 2;  // rows per half-warp per stage
constexpr float kLn2 = 0.6931471805599453f;

// TKV: __nv_bfloat16, or int8_t with f32 per-row scales. A stage holds K
// [kStage][HD], V [kStage][HD] and, on int8 pages, their scales [kStage] each.
template <typename TKV, int HD, int GROUP>
struct Smem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static_assert(kQuant || std::is_same<TKV, __nv_bfloat16>::value,
                "the sm90 decode body takes bf16 or int8 pages");
  static_assert(HD == 128, "a half-warp covers one 128-wide row");
  static constexpr int kRowBytes = HD * sizeof(TKV);
  static constexpr int kTileBytes = kStage * kRowBytes;  // one stage's K (or V)
  static constexpr int kScaleOffset = 2 * kTileBytes;    // K scales, then V scales
  static constexpr int kStageBytes = kScaleOffset + (kQuant ? 2 * kStage * 4 : 0);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // After the stage loop the ring holds, as floats: each consumer warp's
  // partial [warp][acc[G][HD], m[G], l[G], pad to 16 bytes], then the CTA's
  // (the same layout).
  static constexpr int kPartFloats = GROUP * HD + ((2 * GROUP + 3) & ~3);
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

// 16 bytes of a bf16 row -> 8 floats.
__device__ __forceinline__ void unpack8(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 8 bytes of an int8 row -> 8 exact floats: b + 128 (the xor) becomes the
// low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void unpack8(const uint2& raw, float (&x)[8]) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      x[4 * i + b] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | b)) - 8388736.f;
    }
  }
}

// Row t of a stage's K or V tile, this lane's 8 columns (8 hl ..), as floats.
template <typename TKV, int kRowBytes>
__device__ __forceinline__ void load_row8(const unsigned char* tile, int t, int hl,
                                          float (&x)[8]) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    unpack8(reinterpret_cast<const uint2*>(tile + t * kRowBytes)[hl], x);
  } else {
    unpack8(reinterpret_cast<const uint4*>(tile + t * kRowBytes)[hl], x);
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

// Attend the GROUP query heads at q_group ([GROUP][HD], type TQ) over the
// positions [pos0, pos_end) of one sequence and kv head, pos0 page-aligned,
// masking positions below win_lo. `table`: the sequence's block-table row;
// `head_page0`: h * n_pages; `k_scales`/`v_scales`: the int8 pools' f32 row
// scales ([n_kv, n_pages, page], unused on bf16 pages). Every thread of the
// CTA (kThreads) must call it. On return (after a CTA barrier) the CTA's
// partial lies in shared memory at the returned pointer: acc[GROUP][HD]
// (unnormalized), m[GROUP] (log2 domain; -inf where nothing was attended),
// l[GROUP].
template <typename TQ, typename TKV, int HD, int GROUP>
__device__ __forceinline__ const float* attend_range(
    const TQ* __restrict__ q_group, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table, size_t head_page0,
    int n_pages, int page_size, int pos0, int pos_end, int win_lo, float scale_log2) {
  using SM = Smem<TKV, HD, GROUP>;
  constexpr bool kQuant = SM::kQuant;
  static_assert(std::is_same<TQ, __nv_bfloat16>::value, "q is bf16");
  // Tokens per half-warp between two softmax updates: scores s[kTok][GROUP]
  // stay within 16 registers.
  constexpr int kTokWanted = GROUP >= 8 ? 2 : (GROUP >= 4 ? 4 : 8);
  constexpr int kTok = kTokWanted < kTokPerHalf ? kTokWanted : kTokPerHalf;
  static_assert(kTokPerHalf % kTok == 0, "steps tile a stage");

  // (Named apart from paged_decode_common.cuh's array, which the same
  // translation units declare with another alignment.)
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
  const int n_stages = pos_end > pos0 ? (pos_end - pos0 + kStage - 1) / kStage : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's elected lane; on int8 pages every producer lane, once
      // its scale copies have landed.
      mbar_init(full0 + 8 * s, kQuant ? 32 : 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int half = lane >> 4;
  const int hl = lane & 15;  // consumers: columns 8 hl .. 8 hl + 7
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
        if (lane == 0) {
          const uint32_t bytes = (r1 - r0) * SM::kRowBytes;
          mbar_expect_tx(full, 2 * bytes);
          bulk_copy(dst, k_pages + row * HD, bytes, full);
          bulk_copy(dst + SM::kTileBytes, v_pages + row * HD, bytes, full);
        }
        if constexpr (kQuant) {
          // Lanes 0-15 copy the K scales of the piece's rows, 16-31 the V's.
          const float* src = (half ? v_scales : k_scales) + row;
          const uint32_t sdst =
              k_dst + SM::kScaleOffset + half * kStage * 4 + (r0 - s_start) * 4;
          for (int i = hl; i < r1 - r0; i += 16) copy4(sdst + 4 * i, src + i);
        }
      }
      if constexpr (kQuant) {
        copy4_arrive(full);
      } else if (lane == 0) {
        mbar_arrive(full);
      }
    }
  }

  // Consumers (the producer warp runs this part with nothing to do).
  float q[GROUP][8];
  float acc[GROUP][8];
  float m[GROUP], l[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(q_group + g * HD + 8 * hl), x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
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
        float s[kTok][GROUP];
        bool live[kTok];
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          const int t = t_half + i0 + j;
          live[j] = !masked || (t < n_valid && s_start + t >= win_lo);
          float k[8];
          if (live[j]) {
            load_row8<TKV, SM::kRowBytes>(kt, t, hl, k);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) k[e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(q[g][e], k[e], d);
            s[j][g] = d;
          }
        }
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          // A live row's K scale (a masked row's slot may hold a stale NaN).
          const float k_scale = kQuant && live[j] ? k_sc[t_half + i0 + j] : 1.f;
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
#pragma unroll
            for (int o = 8; o; o >>= 1) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
            s[j][g] = live[j] ? (kQuant ? s[j][g] * k_scale : s[j][g]) : -INFINITY;
          }
        }
        // Online softmax: m is warp-uniform; l and acc are per half-warp
        // until the end of the range.
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
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
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
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
          float v[8];
          load_row8<TKV, SM::kRowBytes>(vt, t, hl, v);
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            const float p = kQuant ? s[j][g] * v_scale : s[j][g];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
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
    for (int g = 0; g < GROUP; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      if (lane == 0) {
        mine[GROUP * HD + g] = m[g];
        mine[GROUP * HD + GROUP + g] = l[g];
      }
      if (half == 0) {
        float4* dst = reinterpret_cast<float4*>(mine + g * HD + 8 * hl);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  if (tid < HD) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        mm = fmaxf(mm, scratch[w * SM::kPartFloats + GROUP * HD + g]);
      }
      float ll = 0.f, a = 0.f;
      if (mm != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          const float* pw = scratch + w * SM::kPartFloats;
          const float mw = pw[GROUP * HD + g];
          if (mw == -INFINITY) continue;  // a warp with nothing live
          const float f = exp2f(mw - mm);
          ll = fmaf(f, pw[GROUP * HD + GROUP + g], ll);
          a = fmaf(f, pw[g * HD + tid], a);
        }
      }
      part[g * HD + tid] = a;
      if (tid == 0) {
        part[GROUP * HD + g] = mm;
        part[GROUP * HD + GROUP + g] = ll;
      }
    }
  }
  __syncthreads();
  return part;
}

}  // namespace sm90
