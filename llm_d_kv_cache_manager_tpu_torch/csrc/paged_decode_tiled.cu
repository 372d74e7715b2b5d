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
// tokens, 8 kv heads of 128: 67.2 MB in bf16 (20.0 us at 3.35 TB/s), 134.2
// MB in f32 (40.1 us), 34.7 MB in int8 (10.4 us); at batch 1 x 4096 tokens:
// 16.8 MB bf16 (5.0 us), 33.6 MB f32 (10.0 us) and 8.7 MB int8 (2.6 us).
// The partials this design adds (n_splits x group x
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
// m = -inf, l = 0. The combine pass (paged_decode_combine.cuh, a CTA per
// query row and column block, the splits reduced in parallel) rescales
// each split by exp(m_s - M), skips empty splits, normalizes and writes
// zeros for an all-empty row; `kvt_paged_decode_combine` runs it alone on
// a given workspace. The split count comes from the shapes alone
// (ops/paged_attention.py `decode_plan`, which also sizes paged_decode.cu's
// clusters). No atomics: the result is deterministic.
//
// Every q dtype and page format (bf16 q on bf16 or int8 pages, f32 q on f32
// or int8 pages) runs the body of paged_decode_sm90.cuh: the first port's
// split over the body of paged_decode_common.cuh had CTAs enough (about 320
// at batch 8) but moved 27% of the card's bytes per second on bf16 pages,
// stalling between loads (four CTA barriers and a shared-memory score buffer
// per 64-token chunk, a two-stage ring, a table read per 16-byte copy); the
// new body keeps the math in registers behind a three-stage bulk-copy ring.
//
// Shapes: every head_dim up to 256 (wider heads: paged_decode_wide.cu;
// built at the padded widths 64, 128 and 256, the true head_dim passed at
// run time; the workspace and the output hold the true columns only), any
// GQA group. A group above 8 (4 at head dims above 128) runs as chunks
// over the same kv head (paged_decode_common.cuh, `rows_of`): the grid's
// kv-head axis becomes (kv head, chunk), each chunk reading the kv head's
// pages again (group 12: twice the K/V bytes of one pass), and the
// workspace holds rows_of(group, head_dim) rows per (sequence, kv head,
// chunk, split).

#include "paged_decode_combine.cuh"
#include "paged_decode_common.cuh"
#include "paged_decode_sm90.cuh"

namespace {

// Partial attention of one (sequence, kv head, chunk) over one split of its
// pages, TQ q (bf16 or f32) on TKV pages (q's dtype, or int8), through the
// body of paged_decode_sm90.cuh (its m, in the log2 domain, goes to the
// workspace in natural units). Workspace: m/l [batch, n_kv * n_chunks,
// n_splits, rows], acc [.., rows, hd], f32. BULK: head_dim == HD and the
// chunk's rows == ROWS, both known at compile time; otherwise ROWS is the
// capacity (1 or a CTA's most) and both come at run time.
template <typename TQ, typename TKV, int HD, int ROWS, bool BULK>
__global__ void __launch_bounds__(sm90::kThreads, HD > 128 ? 1 : 2) split_decode_sm90_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, float* __restrict__ m_ws, float* __restrict__ l_ws,
    float* __restrict__ acc_ws, int n_q, int group, int n_pages, int page_size, int table_width,
    int window, float scale_log2, int head_dim, int group_rows) {
  const int hd = BULK ? HD : head_dim;
  const int rows = BULK ? ROWS : group_rows;
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

  const float* part = sm90::attend_range<TQ, TKV, HD, ROWS, BULK>(
      q + (static_cast<size_t>(b) * n_q + c.row0) * hd, k_pages, v_pages, k_scales,
      v_scales, block_tables + static_cast<size_t>(b) * table_width,
      static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo,
      scale_log2, c.n_rows, hd);

  const size_t slot = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n_splits + split;
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    acc_ws[slot * rows * hd + i] = part[i / hd * HD + i % hd];
  }
  if (static_cast<int>(threadIdx.x) < rows) {
    m_ws[slot * rows + threadIdx.x] = part[ROWS * HD + threadIdx.x] * sm90::kLn2;
    l_ws[slot * rows + threadIdx.x] = part[ROWS * HD + ROWS + threadIdx.x];
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
  int batch, n_q, n_kv, group, n_pages, page_size, head_dim, table_width, window, n_splits;
  float scale;
  cudaStream_t stream;
};

// Grid of the split pass: (sequence, kv head x chunk, split).
dim3 split_grid(const Args& a) {
  return dim3(a.batch, a.n_kv * n_chunks_of(a.group, a.head_dim), a.n_splits);
}

// The combine pass of a tiled launch (paged_decode_combine.cuh).
template <typename TQ>
cudaError_t combine_splits(const Args& a) {
  return combine::launch(a.m_ws, a.l_ws, a.acc_ws, static_cast<TQ*>(a.out), a.batch, a.n_q,
                         a.group, a.n_splits, a.head_dim, rows_of(a.group, a.head_dim),
                         a.stream);
}

// The split pass on the body of paged_decode_sm90.cuh, then the combine.
template <typename TQ, typename TKV, int HD, int ROWS, bool BULK>
cudaError_t launch_sm90(const Args& a) {
  const int smem = sm90::Smem<TKV, HD, ROWS>::bytes;
  auto kernel = split_decode_sm90_kernel<TQ, TKV, HD, ROWS, BULK>;
  static std::atomic<unsigned> attributes_set{0};
  const cudaError_t attr = sm90::set_attributes(kernel, smem, attributes_set);
  if (attr != cudaSuccess) return attr;
  kernel<<<split_grid(a), sm90::kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, a.m_ws, a.l_ws, a.acc_ws, a.n_q,
      a.group, a.n_pages, a.page_size, a.table_width, a.window, a.scale * 1.4426950408889634f,
      a.head_dim, rows_of(a.group, a.head_dim));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine_splits<TQ>(a);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_sm90(const Args& a) {
  return with_sm90_shape(a.head_dim, rows_of(a.group, a.head_dim),
                         [&](auto hd, auto rows, auto bulk) {
    return launch_sm90<TQ, TKV, decltype(hd)::value, decltype(rows)::value,
                       decltype(bulk)::value>(a);
  });
}

}  // namespace

// q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size, head_dim];
// k/v scales [n_kv, n_pages, page_size, 1] f32 (int8 pages only, else null);
// block_tables [batch, table_width] int32; seq_lens [batch] int32;
// workspace (rows = rows_of(n_q / n_kv, head_dim), chunks =
// n_chunks_of(n_q / n_kv, head_dim)): m_ws and l_ws [batch, n_kv * chunks,
// n_splits, rows] f32, acc_ws [batch, n_kv * chunks, n_splits, rows,
// head_dim] f32; out [batch, n_q, head_dim]. head_dim 1 to 256 (above it:
// kvt_paged_decode_wide_tiled); any n_q / n_kv (the GQA group). window < 0:
// no sliding window. dtype (of q and out) 0 = f32, 1 = bf16; kv_int8 0:
// pages in the dtype of q, 1: int8 pages with scales.
// Returns the first failing launch's cudaError_t.
extern "C" int kvt_paged_decode_tiled(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* seq_lens, void* m_ws, void* l_ws, void* acc_ws, void* out,
    int batch, int n_q, int n_kv, int n_pages, int page_size, int head_dim,
    int table_width, int window, int n_splits, float scale, int dtype,
    int kv_int8, void* stream) {
  if (head_dim < 1 || head_dim > 256 || n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv < 1 ||
      page_size <= 0 || n_splits <= 0 ||
      (kv_int8 && (k_scales == nullptr || v_scales == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), static_cast<float*>(m_ws),
               static_cast<float*>(l_ws), static_cast<float*>(acc_ws), out,
               batch, n_q, n_kv, n_q / n_kv, n_pages, page_size, head_dim, table_width,
               window, n_splits, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 1) {
    err = kv_int8 ? dispatch_sm90<__nv_bfloat16, int8_t>(a)
                  : dispatch_sm90<__nv_bfloat16, __nv_bfloat16>(a);
  } else if (dtype == 0) {
    err = kv_int8 ? dispatch_sm90<float, int8_t>(a) : dispatch_sm90<float, float>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The combine pass alone (paged_decode_combine.cuh) on a workspace of the
// tiled entry points' layout: m_ws and l_ws [batch, n_kv * chunks,
// n_splits, rows] f32 and acc_ws [batch, n_kv * chunks, n_splits, rows,
// head_dim] f32, where rows is what a chunk of the body that wrote it
// holds (rows_of(n_q / n_kv, head_dim), or hw::rows where
// paged_decode_wide.cu's Hopper body ran) and chunks = ceil((n_q / n_kv) /
// rows); out [batch, n_q, head_dim], dtype 0 = f32, 1 = bf16. Any head_dim,
// n_splits up to 4,096. Returns the launch's cudaError_t.
extern "C" int kvt_paged_decode_combine(const void* m_ws, const void* l_ws, const void* acc_ws,
                                        void* out, int batch, int n_q, int n_kv, int head_dim,
                                        int n_splits, int rows, int dtype, void* stream) {
  if (batch < 1 || n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const float*>(m_ws);
  const auto* l = static_cast<const float*>(l_ws);
  const auto* acc = static_cast<const float*>(acc_ws);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = combine::launch(m, l, acc, static_cast<__nv_bfloat16*>(out), batch, n_q, n_q / n_kv,
                          n_splits, head_dim, rows, s);
  } else if (dtype == 0) {
    err = combine::launch(m, l, acc, static_cast<float*>(out), batch, n_q, n_q / n_kv, n_splits,
                          head_dim, rows, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
