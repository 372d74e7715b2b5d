// The split-KV second pass of both tiled decode sources (paged_decode_tiled.cu
// up to head dim 256, paged_decode_wide.cu above it), after every body that
// writes their workspace, and `kvt_paged_decode_combine` on its own.
//
// With the split passes before it, it replaces the sequential page axis of
// the TPU kernel `_decode_kernel` (llm_d_kv_cache_manager_tpu/ops/
// paged_attention.py:78, and its `quantized=True` instantiation through
// ops/quantized_kv.py:125): there the page axis runs in order and carries
// (m, l, acc) in scratch; here each split writes its partial to an f32
// workspace and this pass merges the splits of each query row:
//   M = max_s m_s over the splits with m_s != -inf, w_s = exp(m_s - M),
//   out = sum_s w_s acc_s / sum_s w_s l_s,
// and an all-empty row (seq_len 0, or every split empty) writes exact
// zeros. No atomics: every sum runs in a fixed order, so two calls give the
// same bits.
//
// Bound on this card: bytes. It reads the workspace once ((head_dim + 2)
// f32 a row and split) and writes the output once: at Qwen2.5-7B's 28/4
// heads of 128 and batch 1 (7 rows x 32 splits a kv head) 0.47 MB, 0.14 us
// at 3.35 TB/s. What it costs beyond that is latency: its launch and a few
// dependent trips to the L2 that the split pass left the workspace in.
//
// Design. The first combine ran a CTA per (sequence, kv head, group chunk)
// with a thread per column, each walking rows x splits in a serial chain
// of dependent loads (m for the max, then m, l and acc again): 2-4 CTAs
// and 224 dependent steps at batch 1 and group 7, about 30 us. Here:
//  - a CTA per (sequence and kv head x chunk; row of the chunk; column
//    block), so that batch 1 spreads over tens of SMs;
//  - its first warp reduces the row's m and l across the splits, strided
//    over its lanes, by shuffles (the max, then sum_s w_s l_s), and leaves
//    each split's weight w_s and 1 / L in shared memory;
//  - then each thread owns VEC columns (a float4 where head_dim % 4 == 0
//    and the workspace is 16-byte aligned, else one) and every J-th split
//    (J = 128 / the block's column vectors), summing w_s acc_s with
//    independent loads; the J partial sums meet in shared memory in a
//    fixed order. Each acc element is read once.
// Any n_splits up to kMaxSplits, any rows, every head dim, f32 or bf16 out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_decode_common.cuh"  // ChunkRows, chunk_rows, from_f; kPanel

namespace {
namespace combine {

constexpr int kThreads = 128;
constexpr int kMaxSplits = 4096;  // their weights fill 16 KB of shared memory

// Column vectors a CTA covers: a row's count rounded up to a power of two,
// at most a warp's 32.
constexpr int block_vecs(int n_vecs) {
  int vb = 1;
  while (vb < n_vecs && vb < 32) vb *= 2;
  return vb;
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

// Grid (pair, row, column block): pair = (sequence, kv head x chunk) of the
// workspace m/l [batch, n_kv * n_chunks, n_splits, rows], acc [.., rows,
// hd]; row = the chunk's row g; a column block = vb vectors of VEC columns.
// Dynamic shared memory: 1 / L (4 floats), the n_splits weights (rounded up
// to 4), then the J x vb x VEC partial sums.
template <typename TQ, int VEC>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ m_ws, const float* __restrict__ l_ws,
    const float* __restrict__ acc_ws, TQ* __restrict__ out, int n_q, int group, int n_splits,
    int hd, int rows, int vb) {
  extern __shared__ float smem[];
  float* inv_l = smem;
  float* w = smem + 4;
  float* part = w + (n_splits + 3) / 4 * 4;
  const int pairs_a_seq = n_q / group * ((group + rows - 1) / rows);
  const int b = blockIdx.x / pairs_a_seq;
  const ChunkRows c = chunk_rows(blockIdx.x % pairs_a_seq, group, rows);
  const int g = blockIdx.y;
  if (g >= c.n_rows) return;  // a spare row of the last chunk: the whole CTA
  const size_t first = static_cast<size_t>(blockIdx.x) * n_splits * rows + g;  // split 0's m
  const int tid = threadIdx.x;

  if (tid < 32) {
    float m_max = -INFINITY;
    for (int s = tid; s < n_splits; s += 32) {
      m_max = fmaxf(m_max, m_ws[first + static_cast<size_t>(s) * rows]);
    }
    for (int o = 16; o; o >>= 1) m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
    float l = 0.f;
    for (int s = tid; s < n_splits; s += 32) {
      const float m = m_ws[first + static_cast<size_t>(s) * rows];
      const float ws = m == -INFINITY ? 0.f : expf(m - m_max);
      w[s] = ws;
      l = fmaf(ws, l_ws[first + static_cast<size_t>(s) * rows], l);
    }
    for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (tid == 0) inv_l[0] = l == 0.f ? 0.f : 1.f / l;
  }
  __syncthreads();

  const int v = tid % vb, j = tid / vb, n_j = kThreads / vb;
  const int col = (blockIdx.z * vb + v) * VEC;
  float o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = 0.f;
  if (col < hd) {
    const size_t step = static_cast<size_t>(n_j) * rows * hd;
    const float* a = acc_ws + (first + static_cast<size_t>(j) * rows) * hd + col;
#pragma unroll 4
    for (int s = j; s < n_splits; s += n_j, a += step) {
      float x[VEC];
      load<VEC>(a, x);
      const float ws = w[s];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = ws == 0.f ? o[e] : fmaf(ws, x[e], o[e]);
    }
  }
  if (n_j > 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[(j * vb + v) * VEC + e] = o[e];
    __syncthreads();
    if (j == 0) {
      for (int jj = 1; jj < n_j; ++jj) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] += part[(jj * vb + v) * VEC + e];
      }
    }
  }
  if (j == 0 && col < hd) {
    const float scale = inv_l[0];  // 1 / L, or 0 for an all-empty row
    TQ* dst = out + (static_cast<size_t>(b) * n_q + c.row0 + g) * hd + col;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = from_f<TQ>(o[e] * scale);
  }
}

// The combine of a tiled launch on `stream`: `rows` a chunk as the body
// that wrote the workspace holds them (rows_of, or hw::rows for the wide
// Hopper body). Returns the launch's cudaError_t.
template <typename TQ>
cudaError_t launch(const float* m_ws, const float* l_ws, const float* acc_ws, TQ* out,
                   int batch, int n_q, int group, int n_splits, int hd, int rows,
                   cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxSplits || rows < 1 || rows > group || hd < 1) {
    return cudaErrorInvalidValue;
  }
  const long long pairs =
      static_cast<long long>(batch) * (n_q / group) * ((group + rows - 1) / rows);
  if (pairs < 1 || pairs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec4 = hd % 4 == 0 && reinterpret_cast<uintptr_t>(acc_ws) % 16 == 0;
  const int vec = vec4 ? 4 : 1;
  const int n_vecs = (hd + vec - 1) / vec;
  const int vb = block_vecs(n_vecs);
  const dim3 grid(static_cast<unsigned>(pairs), rows, (n_vecs + vb - 1) / vb);
  const size_t smem = (4 + (n_splits + 3) / 4 * 4 + kThreads * vec) * sizeof(float);
  if (vec4) {
    combine_kernel<TQ, 4><<<grid, kThreads, smem, stream>>>(m_ws, l_ws, acc_ws, out, n_q, group,
                                                            n_splits, hd, rows, vb);
  } else {
    combine_kernel<TQ, 1><<<grid, kThreads, smem, stream>>>(m_ws, l_ws, acc_ws, out, n_q, group,
                                                            n_splits, hd, rows, vb);
  }
  return cudaGetLastError();
}

}  // namespace combine
}  // namespace
