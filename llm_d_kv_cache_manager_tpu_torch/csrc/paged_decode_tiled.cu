// Split-KV paged decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/paged_attention.py:78, reached through
// `_paged_attention_call` from `paged_attention(pipelined=False)`), in both of
// its instantiations: bf16/f32 pages, and int8 pages with f32 per-row scales
// through `ops/quantized_kv.py::paged_attention_quantized(pipelined=False)`.
// It computes what paged_decode.cu computes: one query token per sequence
// over its block table, online softmax in f32 (scale 1/sqrt(head_dim)), mask
// `pos < seq_len` and, windowed, `pos >= seq_len - window`; `seq_len == 0`
// writes zeros.
//
// Bound on this card: bytes, as for paged_decode.cu. At batch 8 x 2048
// tokens, 8 kv heads of 128: 67.2 MB in bf16 (20.0 us at 3.35 TB/s), 34.7 MB
// in int8 (10.4 us); at batch 1 x 4096 tokens: 16.8 MB bf16 (5.0 us) and
// 8.7 MB int8 (2.6 us). The partials this design adds (n_splits x group x
// (head_dim + 2) f32 per sequence and kv head) are under 2% of that.
//
// Design: on the TPU the page axis of the grid runs in order and carries the
// softmax state in scratch. Blocks on the card run in parallel and in no
// order, so the page axis becomes a parallel split with a second pass. Grid
// (sequence, kv head, split): each CTA takes a contiguous share of the
// sequence's live pages (clipped to the window and to
// ceil(seq_len / page_size), so padding slots of the table are never read)
// and writes the GQA group's (m, l, acc) unnormalized to an f32 workspace
// (one tensor, m, l and acc its views). A split with no live page writes
// m = -inf, l = 0. The combine kernel, one CTA per (sequence, kv head),
// rescales each split by exp(m_s - M), skips empty splits, normalizes and
// writes zeros for an all-empty row. The split count comes from the shapes
// alone (ops/paged_attention.py: `decode_plan` for bf16 q, which also sizes
// paged_decode.cu's clusters; `old_body_splits` for f32 q). No atomics: the
// result is deterministic.
//
// bf16 q, on bf16 or int8 pages, runs the body of paged_decode_sm90.cuh: the
// first port's split over the body of paged_decode_common.cuh had CTAs enough
// (about 320 at batch 8) but moved 27% of the card's bytes per second on
// bf16 pages, stalling between loads (four CTA barriers and a shared-memory
// score buffer per 64-token chunk, a two-stage ring, a table read per
// 16-byte copy); the new body keeps the math in registers behind a
// three-stage bulk-copy ring. f32 q (the checking paths, on f32 or int8
// pages) keeps the old body.

#include "paged_decode_common.cuh"
#include "paged_decode_sm90.cuh"

namespace {

// Partial attention of one (sequence, kv head) over one split of its pages.
// Workspace: m/l [batch, n_kv, n_splits, GROUP], acc [.., GROUP, HD], f32.
template <typename TQ, typename TKV, int HD, int GROUP>
__global__ void __launch_bounds__(HD) split_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, float* __restrict__ m_ws,
    float* __restrict__ l_ws, float* __restrict__ acc_ws, int n_q, int n_pages,
    int page_size, int table_width, int window, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int seq_len = seq_lens[b];
  // Positions past the table do not exist, as in the plain version's gather.
  const int kv_len = min(seq_len, table_width * page_size);
  const int first_page = window < 0 ? 0 : max(seq_len - window, 0) / page_size;
  const int win_lo = window < 0 ? 0 : seq_len - window;
  const int n_seq_pages = (kv_len + page_size - 1) / page_size;
  const int per_split = (max(n_seq_pages - first_page, 0) + n_splits - 1) / n_splits;
  const int lo_page = first_page + split * per_split;
  const int hi_page = min(lo_page + per_split, n_seq_pages);

  float acc[GROUP], m[GROUP], l[GROUP];
  attend_range<TQ, TKV, HD, GROUP>(
      q + (static_cast<size_t>(b) * n_q + h * GROUP) * HD, k_pages, v_pages,
      k_scales, v_scales, block_tables + static_cast<size_t>(b) * table_width,
      static_cast<size_t>(h) * n_pages, n_pages, page_size,
      lo_page * page_size, min(hi_page * page_size, kv_len), win_lo, scale,
      acc, m, l);

  const size_t part = (static_cast<size_t>(b) * gridDim.y + h) * n_splits + split;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    acc_ws[(part * GROUP + g) * HD + threadIdx.x] = acc[g];
    if (threadIdx.x == 0) {
      m_ws[part * GROUP + g] = m[g];
      l_ws[part * GROUP + g] = l[g];
    }
  }
}

// The same partial for bf16 q on TKV (bf16 or int8) pages, through the body
// of paged_decode_sm90.cuh (its m, in the log2 domain, goes to the workspace
// in natural units).
template <typename TKV, int HD, int GROUP>
__global__ void __launch_bounds__(sm90::kThreads, 2) split_decode_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, float* __restrict__ m_ws, float* __restrict__ l_ws,
    float* __restrict__ acc_ws, int n_q, int n_pages, int page_size, int table_width,
    int window, float scale_log2) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
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

  const float* part = sm90::attend_range<__nv_bfloat16, TKV, HD, GROUP>(
      q + (static_cast<size_t>(b) * n_q + h * GROUP) * HD, k_pages, v_pages, k_scales,
      v_scales, block_tables + static_cast<size_t>(b) * table_width,
      static_cast<size_t>(h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo,
      scale_log2);

  const size_t slot = (static_cast<size_t>(b) * gridDim.y + h) * n_splits + split;
  for (int i = threadIdx.x; i < GROUP * HD; i += blockDim.x) {
    acc_ws[slot * GROUP * HD + i] = part[i];
  }
  if (threadIdx.x < GROUP) {
    m_ws[slot * GROUP + threadIdx.x] = part[GROUP * HD + threadIdx.x] * sm90::kLn2;
    l_ws[slot * GROUP + threadIdx.x] = part[GROUP * HD + GROUP + threadIdx.x];
  }
}

// Second pass: merge the splits of one (sequence, kv head) and normalize.
template <typename TQ, int HD, int GROUP>
__global__ void __launch_bounds__(HD) combine_kernel(
    const float* __restrict__ m_ws, const float* __restrict__ l_ws,
    const float* __restrict__ acc_ws, TQ* __restrict__ out, int n_q,
    int n_splits) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int n_kv = gridDim.y;
  const int tid = threadIdx.x;
  const size_t part0 = (static_cast<size_t>(b) * n_kv + h) * n_splits;
  for (int g = 0; g < GROUP; ++g) {
    float m_max = -INFINITY;
    for (int s = 0; s < n_splits; ++s) {
      m_max = fmaxf(m_max, m_ws[(part0 + s) * GROUP + g]);
    }
    float l = 0.f, o = 0.f;
    if (m_max != -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {
        const float m = m_ws[(part0 + s) * GROUP + g];
        if (m == -INFINITY) continue;  // a split with no live position
        const float w = expf(m - m_max);
        l += w * l_ws[(part0 + s) * GROUP + g];
        o += w * acc_ws[((part0 + s) * GROUP + g) * HD + tid];
      }
    }
    out[(static_cast<size_t>(b) * n_q + h * GROUP + g) * HD + tid] =
        from_f<TQ>(l == 0.f ? 0.f : o / l);
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
  float* m_ws;
  float* l_ws;
  float* acc_ws;
  void* out;
  int batch, n_q, n_kv, n_pages, page_size, table_width, window, n_splits;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, int HD, int GROUP>
cudaError_t combine(const Args& a) {
  combine_kernel<TQ, HD, GROUP><<<dim3(a.batch, a.n_kv), HD, 0, a.stream>>>(
      a.m_ws, a.l_ws, a.acc_ws, static_cast<TQ*>(a.out), a.n_q, a.n_splits);
  return cudaGetLastError();
}

// f32 q: the body of paged_decode_common.cuh.
template <typename TQ, typename TKV, int HD, int GROUP>
cudaError_t launch(const Args& a) {
  const int smem = static_cast<int>(DecodeSmem<TKV, HD, GROUP>::bytes);
  auto kernel = split_decode_kernel<TQ, TKV, HD, GROUP>;
  static std::atomic<unsigned> attributes_set{0};
  const cudaError_t attr = sm90::set_attributes(kernel, smem, attributes_set);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(a.batch, a.n_kv, a.n_splits), HD, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, a.m_ws, a.l_ws,
      a.acc_ws, a.n_q, a.n_pages, a.page_size, a.table_width, a.window,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine<TQ, HD, GROUP>(a);
}

// bf16 q: the body of paged_decode_sm90.cuh.
template <typename TKV, int HD, int GROUP>
cudaError_t launch_sm90(const Args& a) {
  const int smem = sm90::Smem<TKV, HD, GROUP>::bytes;
  auto kernel = split_decode_sm90_kernel<TKV, HD, GROUP>;
  static std::atomic<unsigned> attributes_set{0};
  const cudaError_t attr = sm90::set_attributes(kernel, smem, attributes_set);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(a.batch, a.n_kv, a.n_splits), sm90::kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, a.m_ws, a.l_ws, a.acc_ws, a.n_q,
      a.n_pages, a.page_size, a.table_width, a.window, a.scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine<__nv_bfloat16, HD, GROUP>(a);
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

template <typename TKV>
cudaError_t dispatch_sm90(int group, const Args& a) {
  switch (group) {
    case 1: return launch_sm90<TKV, 128, 1>(a);
    case 2: return launch_sm90<TKV, 128, 2>(a);
    case 4: return launch_sm90<TKV, 128, 4>(a);
    case 8: return launch_sm90<TKV, 128, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size, head_dim];
// k/v scales [n_kv, n_pages, page_size, 1] f32 (int8 pages only, else null);
// block_tables [batch, table_width] int32; seq_lens [batch] int32;
// workspace: m_ws and l_ws [batch, n_kv, n_splits, n_q / n_kv] f32, acc_ws
// [batch, n_kv, n_splits, n_q / n_kv, head_dim] f32; out [batch, n_q,
// head_dim]. window < 0: no sliding window. dtype (of q and out) 0 = f32,
// 1 = bf16; kv_int8 0: pages in the dtype of q, 1: int8 pages with scales.
// Returns the first failing launch's cudaError_t.
extern "C" int kvt_paged_decode_tiled(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* seq_lens, void* m_ws, void* l_ws, void* acc_ws, void* out,
    int batch, int n_q, int n_kv, int n_pages, int page_size, int head_dim,
    int table_width, int window, int n_splits, float scale, int dtype,
    int kv_int8, void* stream) {
  if (head_dim != 128 || n_kv <= 0 || n_q % n_kv != 0 || page_size <= 0 ||
      n_splits <= 0 || (kv_int8 && (k_scales == nullptr || v_scales == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), static_cast<float*>(m_ws),
               static_cast<float*>(l_ws), static_cast<float*>(acc_ws), out,
               batch, n_q, n_kv, n_pages, page_size, table_width, window,
               n_splits, scale, static_cast<cudaStream_t>(stream)};
  const int group = n_q / n_kv;
  cudaError_t err;
  if (dtype == 1) {
    err = kv_int8 ? dispatch_sm90<int8_t>(group, a) : dispatch_sm90<__nv_bfloat16>(group, a);
  } else if (dtype == 0) {
    err = kv_int8 ? dispatch_group<float, int8_t>(group, a)
                  : dispatch_group<float, float>(group, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
