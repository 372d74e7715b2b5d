// Paged flash-decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel_pipelined` of the reference
// package (llm_d_kv_cache_manager_tpu/ops/paged_attention.py), in both of its
// instantiations: bf16/f32 pages through `paged_attention(pipelined=True)`,
// and int8 pages with f32 per-row scales through
// `ops/quantized_kv.py::paged_attention_quantized(pipelined=True)`. One query
// token per sequence attends over that sequence's KV pages, found through
// its block table, with an online softmax in f32 (scale 1/sqrt(head_dim)),
// mask `pos < seq_len` and, with a sliding window, `pos >= seq_len - window`
// (pages wholly below the window are never read). A `seq_len == 0` slot
// writes zeros.
//
// Bound on this card: bytes. Every K and V row of every live position is
// read once and used for 2*group FLOPs per element, far below the ~295
// FLOP/byte at which an H100 turns compute-bound. At the flagship decode
// shape (batch 8, 2048 tokens, 8 kv heads, head_dim 128) one layer call
// must move 67.1 MB in bf16 (20.0 us at 3.35 TB/s) and 34.6 MB in int8
// (33.55 MB of values plus 1.05 MB of scales: 10.3 us).
//
// Design: one CTA per (sequence, kv head), one thread per head_dim lane,
// walking all of the sequence's live positions (from the first page inside
// the window) through the cp.async ring of paged_decode_common.cuh, which
// moves K/V once per kv head for the whole GQA group and keeps int8 scales
// out of the inner products. Block-table entries past
// ceil(seq_len / page_size) are never read. Not yet done (later work): a
// split over the sequence for small batches (batch 8 x 8 heads is 64 CTAs on
// 132 SMs; paged_decode_tiled.cu splits), wgmma and TMA.

#include "paged_decode_common.cuh"

namespace {

template <typename TQ, typename TKV, int HD, int GROUP>
__global__ void __launch_bounds__(HD) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, TQ* __restrict__ out, int n_q,
    int n_pages, int page_size, int table_width, int window, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int seq_len = seq_lens[b];
  // Positions past the table do not exist, as in the plain version's gather.
  const int kv_len = min(seq_len, table_width * page_size);
  const int first_page = window < 0 ? 0 : max(seq_len - window, 0) / page_size;
  const int win_lo = window < 0 ? 0 : seq_len - window;
  const size_t q0 = (static_cast<size_t>(b) * n_q + h * GROUP) * HD;

  float acc[GROUP], m[GROUP], l[GROUP];
  attend_range<TQ, TKV, HD, GROUP>(
      q + q0, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width,
      static_cast<size_t>(h) * n_pages, n_pages, page_size,
      first_page * page_size, kv_len, win_lo, scale, acc, m, l);

#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    out[q0 + g * HD + threadIdx.x] = from_f<TQ>(acc[g] / (l[g] == 0.f ? 1.f : l[g]));
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
  int batch, n_q, n_kv, n_pages, page_size, table_width, window;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD, int GROUP>
cudaError_t launch(const Args& a) {
  const size_t smem = DecodeSmem<TKV, HD, GROUP>::bytes;
  auto kernel = paged_decode_kernel<TQ, TKV, HD, GROUP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.batch, a.n_kv), HD, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl,
      static_cast<TQ*>(a.out), a.n_q, a.n_pages, a.page_size, a.table_width,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<TQ, TKV, 128, 1>(a);
    case 2: return launch<TQ, TKV, 128, 2>(a);
    case 4: return launch<TQ, TKV, 128, 4>(a);
    case 8: return launch<TQ, TKV, 128, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size, head_dim];
// k/v scales [n_kv, n_pages, page_size, 1] f32 (int8 pages only, else null);
// block_tables [batch, table_width] int32; seq_lens [batch] int32;
// out [batch, n_q, head_dim]. window < 0: no sliding window. dtype (of q and
// out) 0 = f32, 1 = bf16; kv_int8 0: pages in the dtype of q, 1: int8 pages
// with scales. Returns the launch's cudaError_t.
extern "C" int kvt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales,
                                const void* v_scales, const void* block_tables,
                                const void* seq_lens, void* out, int batch,
                                int n_q, int n_kv, int n_pages, int page_size,
                                int head_dim, int table_width, int window,
                                float scale, int dtype, int kv_int8,
                                void* stream) {
  if (head_dim != 128 || n_kv <= 0 || n_q % n_kv != 0 || page_size <= 0 ||
      (kv_int8 && (k_scales == nullptr || v_scales == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), out, batch, n_q, n_kv,
               n_pages, page_size, table_width, window, scale,
               static_cast<cudaStream_t>(stream)};
  const int group = n_q / n_kv;
  cudaError_t err;
  if (dtype == 1) {
    err = kv_int8 ? dispatch_group<__nv_bfloat16, int8_t>(group, a)
                  : dispatch_group<__nv_bfloat16, __nv_bfloat16>(group, a);
  } else if (dtype == 0) {
    err = kv_int8 ? dispatch_group<float, int8_t>(group, a)
                  : dispatch_group<float, float>(group, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
