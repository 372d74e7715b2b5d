// Paged flash-decoding attention for Hopper (sm_90a): one launch per call.
//
// Replaces the TPU kernel `_decode_kernel_pipelined` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157), in both of its
// instantiations: bf16/f32 pages through `paged_attention(pipelined=True)`,
// and int8 pages with f32 per-row scales through
// `ops/quantized_kv.py::paged_attention_quantized(pipelined=True)`. One query
// token per sequence attends over that sequence's KV pages, found through
// its block table, with an online softmax in f32 (scale 1/sqrt(head_dim)),
// mask `pos < seq_len` and, with a sliding window, `pos >= seq_len - window`
// (pages wholly below the window are never read). A `seq_len == 0` slot
// writes zeros. Like the TPU kernel, one launch carries each sequence end to
// end: no workspace, no second pass, no atomics (two calls give the same
// bits).
//
// Bound on this card: bytes. Every K and V row of every live position is
// read once and used for 2*group FLOPs per element, far below the ~295
// FLOP/byte at which an H100 turns compute-bound. At the flagship decode
// shape (batch 8, 2048 tokens, 8 kv heads, head_dim 128) one layer call
// must move 67.2 MB in bf16 (20.0 us at 3.35 TB/s), 134.2 MB in f32 (40.1
// us) and 34.7 MB in int8 (10.4 us).
//
// The first port ran one 128-thread CTA per (sequence, kv head) over the
// body of paged_decode_common.cuh: 64 CTAs on 132 SMs at batch 8, and 8 CTAs
// at batch 1, the shape a pod decodes one request at; the body itself stalled
// between loads (paged_decode_sm90.cuh lists where). Here, for bf16 q on
// bf16 or int8 pages and for f32 q on f32 or int8 pages alike, the live
// pages of each (sequence, kv head) are split over a thread-block cluster of
// `cluster` CTAs (grid cluster x kv heads x batch, the cluster along x),
// each running the body of paged_decode_sm90.cuh over a contiguous share and
// leaving its partial (m, l, acc) in its own shared memory. After a cluster
// barrier each rank merges one slice of the head_dim columns from every rank
// through distributed shared memory, in rank order, in f32, and writes the
// normalized output in q's dtype; a second cluster barrier keeps every CTA's
// shared memory alive until its peers have read it. A rank with no live page
// still reaches both barriers with m = -inf, l = 0. The cluster size (a power
// of two, at most the portable 8) comes from the shapes:
// ops/paged_attention.py `decode_plan`.
//
// Shapes: every head_dim up to 256 (wider heads: paged_decode_wide.cu),
// built at the padded widths 64, 128 and 256 with the true head_dim passed
// at run time (the body's notes say how unpadded rows are copied); any GQA
// group. A group above 8 (4 at head dims above 128) runs as chunks over the
// same kv head (paged_decode_common.cuh, `rows_of`): one more cluster per
// chunk, each reading the kv head's pages again, so group 12 moves twice the
// K/V bytes of one pass and group 71 nine times.

#include <cooperative_groups.h>

#include "paged_decode_common.cuh"
#include "paged_decode_sm90.cuh"

namespace {

// TQ q (bf16 or f32) on TKV pages (q's dtype, or int8): rank blockIdx.x of
// the cluster of (sequence blockIdx.z, kv head and chunk blockIdx.y) attends
// over its share of the live pages; the cluster then merges through
// distributed shared memory. BULK: head_dim == HD and the chunk's rows ==
// ROWS, both known at compile time; otherwise ROWS is the capacity (1 or a
// CTA's most) and both come at run time.
template <typename TQ, typename TKV, int HD, int ROWS, bool BULK>
__global__ void __launch_bounds__(sm90::kThreads, HD > 128 ? 1 : 2) paged_decode_cluster_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, TQ* __restrict__ out, int n_q, int group,
    int n_pages, int page_size, int table_width, int window, float scale_log2, int head_dim,
    int group_rows) {
  const int hd = BULK ? HD : head_dim;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const ChunkRows c = chunk_rows(blockIdx.y, group, BULK ? ROWS : group_rows);
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

  const float* part = sm90::attend_range<TQ, TKV, HD, ROWS, BULK>(
      q + q0, k_pages, v_pages, k_scales, v_scales,
      block_tables + static_cast<size_t>(b) * table_width, static_cast<size_t>(c.h) * n_pages,
      n_pages, page_size, lo_page * page_size, min(hi_page * page_size, kv_len), win_lo,
      scale_log2, c.n_rows, hd);

  cluster.sync();  // every rank's partial is in its shared memory
  // Each rank merges HD / n_ranks columns of the padded width (the cluster,
  // a power of two up to 8, divides 64, 128 and 256) and writes those below
  // hd.
  const int cols = HD / n_ranks;
  for (int i = threadIdx.x; i < c.n_rows * cols; i += blockDim.x) {
    const int g = i / cols;
    const int col = rank * cols + i % cols;
    float mm = -INFINITY;
    for (int r = 0; r < n_ranks; ++r) {
      mm = fmaxf(mm, cluster.map_shared_rank(part, r)[ROWS * HD + g]);
    }
    float ll = 0.f, a = 0.f;
    if (mm != -INFINITY) {
      for (int r = 0; r < n_ranks; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float mr = pr[ROWS * HD + g];
        if (mr == -INFINITY) continue;  // a rank with no live position
        const float f = exp2f(mr - mm);
        ll = fmaf(f, pr[ROWS * HD + ROWS + g], ll);
        a = fmaf(f, pr[g * HD + col], a);
      }
    }
    if (col < hd) out[q0 + g * hd + col] = from_f<TQ>(ll == 0.f ? 0.f : a / ll);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
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
  int batch, n_q, n_kv, group, n_pages, page_size, head_dim, table_width, window, cluster;
  float scale;
  cudaStream_t stream;
};

// One cluster of `a.cluster` CTAs per (sequence, kv head, chunk).
template <typename TQ, typename TKV, int HD, int ROWS, bool BULK>
cudaError_t launch_cluster(const Args& a) {
  constexpr int smem = sm90::Smem<TKV, HD, ROWS>::bytes;
  auto kernel = paged_decode_cluster_kernel<TQ, TKV, HD, ROWS, BULK>;
  static std::atomic<unsigned> attributes_set{0};
  cudaError_t err = sm90::set_attributes(kernel, smem, attributes_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.n_kv * n_chunks_of(a.group, a.head_dim), a.batch);
  cfg.blockDim = dim3(sm90::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.bt, a.sl, static_cast<TQ*>(a.out),
      a.n_q, a.group, a.n_pages, a.page_size, a.table_width, a.window,
      a.scale * 1.4426950408889634f, a.head_dim, rows_of(a.group, a.head_dim));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_cluster(const Args& a) {
  return with_sm90_shape(a.head_dim, rows_of(a.group, a.head_dim),
                         [&](auto hd, auto rows, auto bulk) {
    return launch_cluster<TQ, TKV, decltype(hd)::value, decltype(rows)::value,
                          decltype(bulk)::value>(a);
  });
}

}  // namespace

// q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size, head_dim];
// k/v scales [n_kv, n_pages, page_size, 1] f32 (int8 pages only, else null);
// block_tables [batch, table_width] int32; seq_lens [batch] int32;
// out [batch, n_q, head_dim]. head_dim 1 to 256 (above it:
// kvt_paged_decode_wide); any n_q / n_kv (the GQA group). window < 0: no
// sliding window. cluster: CTAs per (sequence, kv head, group chunk), a
// power of two up to 8.
// dtype (of q and out) 0 = f32, 1 = bf16; kv_int8 0: pages in the dtype of
// q, 1: int8 pages with scales.
// Returns the launch's cudaError_t.
extern "C" int kvt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales,
                                const void* v_scales, const void* block_tables,
                                const void* seq_lens, void* out, int batch,
                                int n_q, int n_kv, int n_pages, int page_size,
                                int head_dim, int table_width, int window,
                                int cluster, float scale, int dtype, int kv_int8,
                                void* stream) {
  if (head_dim < 1 || head_dim > 256 || n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv < 1 ||
      page_size <= 0 ||
      (kv_int8 && (k_scales == nullptr || v_scales == nullptr)) || cluster <= 0 ||
      cluster > 8 || (cluster & (cluster - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens), out, batch, n_q, n_kv, n_q / n_kv,
               n_pages, page_size, head_dim, table_width, window, cluster, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 1) {
    err = kv_int8 ? dispatch_cluster<__nv_bfloat16, int8_t>(a)
                  : dispatch_cluster<__nv_bfloat16, __nv_bfloat16>(a);
  } else if (dtype == 0) {
    err = kv_int8 ? dispatch_cluster<float, int8_t>(a) : dispatch_cluster<float, float>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
