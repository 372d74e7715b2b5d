// Paged flash-decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel_pipelined` of the reference
// package (llm_d_kv_cache_manager_tpu/ops/paged_attention.py, reached through
// `paged_attention(pipelined=True)`): one query token per sequence attends
// over that sequence's KV pages, found through its block table, with an
// online softmax in f32 (scale 1/sqrt(head_dim)), mask `pos < seq_len` and,
// with a sliding window, `pos >= seq_len - window` (pages wholly below the
// window are never read). A `seq_len == 0` slot writes zeros.
//
// Bound on this card: bytes. Every K and V row of every live position is
// read once and used for 2*group FLOPs per element, far below the ~295
// FLOP/byte at which an H100 turns compute-bound. At the flagship decode
// shape (batch 8, 2048 tokens, 8 kv heads, head_dim 128, bf16) one layer
// call must move 67.1 MB, 20.0 us at 3.35 TB/s.
//
// Design: one CTA per (sequence, kv head), one thread per head_dim lane.
// The CTA walks its pages 64 tokens at a time (a chunk is 64/page_size
// pages) through a two-stage cp.async ring, so the next chunk's K and V
// are in flight while the current one is scored; 16-byte copies, rows
// padded by 16 bytes so the per-token score loop reads shared memory
// without bank conflicts. The GQA group shares each staged page, so K/V
// move once per kv head, not once per query head. Block-table entries past
// ceil(seq_len / page_size) are never read. Not yet done (later work): a
// split over the sequence for small batches (batch 8 x 8 heads is 64 CTAs
// on 132 SMs), wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;  // tokens staged per pipeline step

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int HD, int GROUP>
struct DecodeSmem {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kRow = HD + kVec;       // padded K/V row, elements
  static constexpr size_t kv_bytes = 2ull * kChunk * kRow * sizeof(T);
  static constexpr size_t bytes =
      2 * kv_bytes + sizeof(float) * (GROUP * HD + GROUP * kChunk + 3 * GROUP);
};

template <typename T, int HD, int GROUP>
__global__ void __launch_bounds__(HD) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, T* __restrict__ out, int n_q,
    int n_pages, int page_size, int table_width, int window, float scale) {
  using SM = DecodeSmem<T, HD, GROUP>;
  constexpr int kThreads = HD;  // one thread per output lane
  constexpr int kWarps = kThreads / 32;
  constexpr int kVec = SM::kVec;
  constexpr int kRow = SM::kRow;
  constexpr int kVecPerRow = HD / kVec;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                // [2][kChunk][kRow]
  T* vs = reinterpret_cast<T*>(smem + SM::kv_bytes);  // [2][kChunk][kRow]
  float* qs = reinterpret_cast<float*>(smem + 2 * SM::kv_bytes);  // [GROUP][HD]
  float* ss = qs + GROUP * HD;       // [GROUP][kChunk] scores, then probs
  float* m_s = ss + GROUP * kChunk;  // [GROUP] running max
  float* l_s = m_s + GROUP;          // [GROUP] running normalizer
  float* a_s = l_s + GROUP;          // [GROUP] this chunk's rescale

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int seq_len = seq_lens[b];
  const int n_seq_pages = (seq_len + page_size - 1) / page_size;
  const int first_page = window < 0 ? 0 : max(seq_len - window, 0) / page_size;
  const int win_lo = window < 0 ? 0 : seq_len - window;
  const int pages_per_chunk = kChunk / page_size;
  const int n_chunks = n_seq_pages > first_page
      ? (n_seq_pages - first_page + pages_per_chunk - 1) / pages_per_chunk
      : 0;
  const int* table = block_tables + static_cast<size_t>(b) * table_width;
  const size_t head_page0 = static_cast<size_t>(h) * n_pages;

  for (int i = tid; i < GROUP * HD; i += kThreads) {
    qs[i] = to_f(q[(static_cast<size_t>(b) * n_q + h * GROUP) * HD + i]);
  }
  if (tid < GROUP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // Stage chunk c (pages first_page + c*pages_per_chunk ...) into `stage`.
  auto load_chunk = [&](int stage, int c) {
    const int page0 = first_page + c * pages_per_chunk;
    T* kd = ks + stage * kChunk * kRow;
    T* vd = vs + stage * kChunk * kRow;
    for (int i = tid; i < kChunk * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int vec = i % kVecPerRow;
      const int pi = page0 + t / page_size;
      if (pi >= n_seq_pages || pi >= table_width) continue;
      const int page = table[pi];
      if (page < 0 || page >= n_pages) continue;
      const size_t src =
          ((head_page0 + page) * page_size + t % page_size) * HD + vec * kVec;
      cp_async16(kd + t * kRow + vec * kVec, k_pages + src);
      cp_async16(vd + t * kRow + vec * kVec, v_pages + src);
    }
    cp_async_commit();
  };

  float acc[GROUP];
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

    const T* kc = ks + stage * kChunk * kRow;
    const T* vc = vs + stage * kChunk * kRow;
    const int c_start = (first_page + c * pages_per_chunk) * page_size;
    const int t_end = min(kChunk, seq_len - c_start);

    // Scores: one (group row, token) pair per thread per step.
    for (int p = tid; p < GROUP * kChunk; p += kThreads) {
      const int g = p / kChunk;
      const int t = p % kChunk;
      float s = -INFINITY;
      if (t < t_end && c_start + t >= win_lo) {
        const float* qg = qs + g * HD;
        const uint4* kr = reinterpret_cast<const uint4*>(kc + t * kRow);
        float dot = 0.f;
#pragma unroll 4
        for (int vec = 0; vec < kVecPerRow; ++vec) {
          const uint4 raw = kr[vec];
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot += qg[vec * kVec + j] * to_f(e[j]);
        }
        s = dot * scale;
      }
      ss[p] = s;
    }
    __syncthreads();

    // Online softmax, one warp per group row; probabilities overwrite ss.
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
      ss[g * kChunk + lane] = p0;
      ss[g * kChunk + lane + 32] = p1;
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
    const float l = l_s[g];
    out[(static_cast<size_t>(b) * n_q + h * GROUP + g) * HD + tid] =
        from_f<T>(acc[g] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int HD, int GROUP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt,
                   const void* sl, void* out, int batch, int n_q, int n_kv,
                   int n_pages, int page_size, int table_width, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = DecodeSmem<T, HD, GROUP>::bytes;
  auto kernel = paged_decode_kernel<T, HD, GROUP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch, n_kv), HD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(sl), static_cast<T*>(out), n_q, n_pages,
      page_size, table_width, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(int group, const void* q, const void* k,
                           const void* v, const void* bt, const void* sl,
                           void* out, int batch, int n_q, int n_kv, int n_pages,
                           int page_size, int table_width, int window,
                           float scale, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, HD, 1>(q, k, v, bt, sl, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, stream);
    case 2: return launch<T, HD, 2>(q, k, v, bt, sl, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, stream);
    case 4: return launch<T, HD, 4>(q, k, v, bt, sl, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, stream);
    case 8: return launch<T, HD, 8>(q, k, v, bt, sl, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [batch, n_q, head_dim]; k/v pages [n_kv, n_pages, page_size, head_dim];
// block_tables [batch, table_width] int32; seq_lens [batch] int32;
// out [batch, n_q, head_dim]. window < 0: no sliding window. dtype 0 = f32,
// 1 = bf16. Returns the launch's cudaError_t.
extern "C" int kvt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* seq_lens, void* out, int batch,
                                int n_q, int n_kv, int n_pages, int page_size,
                                int head_dim, int table_width, int window,
                                float scale, int dtype, void* stream) {
  if (head_dim != 128 || n_kv <= 0 || n_q % n_kv != 0 || page_size <= 0 ||
      kChunk % page_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = n_q / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = dispatch_group<__nv_bfloat16, 128>(group, q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, s);
  } else if (dtype == 0) {
    err = dispatch_group<float, 128>(group, q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_q, n_kv, n_pages, page_size, table_width, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
