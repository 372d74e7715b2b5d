// Causal flash attention for chunked prefill on Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/flash_prefill.py, reached through
// `flash_prefill` from the serving prefill path): q row i of batch b attends
// key positions k <= off[b] + i and k < kv_len, and with a sliding window
// also k > off[b] + i - window. The GQA group is folded into the rows of a
// tile, so the group's query heads share every K/V tile. Operands stay in
// the model dtype with f32 accumulation, the softmax runs online in f32,
// and the probabilities are cast to the V dtype before P @ V, as the TPU
// kernel does. Fully masked rows write zeros.
//
// Bound on this card: operations. A causal 2048 x 2048 chunk with 16 query
// heads of 128 does 17.2 GFLOP per layer call (QK^T and PV over the
// causal half) against ~17 MB of q/k/v/out traffic: 17.4 us at 989 TFLOP/s
// bf16 dense, the bytes a third of that.
//
// Design: one CTA (8 warps) per (q-block, kv head, batch) holding 64 rows
// = (64 / group) query positions x group heads. It walks only the k-blocks
// of 64 keys in [first_blk, last_blk] (those above the diagonal or below
// the window are neither loaded nor computed); K and V of a block arrive by
// cp.async in two groups so V's load overlaps the QK^T product and the
// softmax. bf16 products run on the tensor cores through WMMA 16x16x16
// fragments with f32 accumulators; the f32 variant (checks, tests) uses
// CUDA-core FMAs in the same structure. Scores, probabilities and the
// running output live in shared memory, so the per-row rescale by alpha
// is a plain shared-memory pass. Not yet done (later work): wgmma, TMA,
// register-resident accumulators (FA2/FA3 layout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kRows = 64;  // q rows per CTA (positions x group heads)
constexpr int kBlockK = 64;  // keys per k-block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Shared-memory plan. Rows are padded by 16 bytes (T) or 16 bytes (float)
// against bank conflicts; every region and fragment start stays 32-byte
// aligned, as WMMA loads and stores require.
template <typename T, int HD>
struct FlashSmem {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int LQ = HD + kVec;     // q/k/v rows, elements of T
  static constexpr int LS = kBlockK + 4;   // score rows, floats
  static constexpr int LP = kBlockK + kVec;  // probability rows, elements of T
  static constexpr int LO = HD + 4;        // output accumulator rows, floats
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * kRows * LQ;
  static constexpr size_t v_off = k_off + sizeof(T) * kBlockK * LQ;
  static constexpr size_t s_off = v_off + sizeof(T) * kBlockK * LQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kRows * LS;
  static constexpr size_t o_off = p_off + sizeof(T) * kRows * LP;
  static constexpr size_t m_off = o_off + sizeof(float) * kRows * LO;
  static constexpr size_t bytes = m_off + sizeof(float) * 2 * kRows;
};

// S[kRows][kBlockK] = Q[kRows][HD] @ K[kBlockK][HD]^T (unscaled).
template <typename T, int HD>
__device__ __forceinline__ void scores_tile(const T* qs, const T* ks, float* ss,
                                            int tid) {
  using SM = FlashSmem<T, HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5;
    constexpr int kTilesN = kBlockK / 16;
    for (int t = warp; t < (kRows / 16) * kTilesN; t += kWarps) {
      const int ti = t / kTilesN;
      const int tj = t % kTilesN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + ti * 16 * SM::LQ + kk, SM::LQ);
        wmma::load_matrix_sync(b, ks + tj * 16 * SM::LQ + kk, SM::LQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + ti * 16 * SM::LS + tj * 16, acc, SM::LS,
                              wmma::mem_row_major);
    }
  } else {
    // 16 x 16 thread grid, each thread a 4 x 4 block of scores.
    const int r0 = (tid / 16) * 4;
    const int c0 = (tid % 16) * 4;
    float acc[4][4] = {};
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(qs[(r0 + i) * SM::LQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f(ks[(c0 + j) * SM::LQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ss[(r0 + i) * SM::LS + c0 + j] = acc[i][j];
  }
}

// O[kRows][HD] += P[kRows][kBlockK] @ V[kBlockK][HD].
template <typename T, int HD>
__device__ __forceinline__ void pv_tile(const T* ps, const T* vs, float* os,
                                        int tid) {
  using SM = FlashSmem<T, HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5;
    constexpr int kTilesN = HD / 16;
    for (int t = warp; t < (kRows / 16) * kTilesN; t += kWarps) {
      const int ti = t / kTilesN;
      const int tn = t % kTilesN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + ti * 16 * SM::LO + tn * 16, SM::LO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + ti * 16 * SM::LP + kk, SM::LP);
        wmma::load_matrix_sync(b, vs + kk * SM::LQ + tn * 16, SM::LQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(os + ti * 16 * SM::LO + tn * 16, acc, SM::LO,
                              wmma::mem_row_major);
    }
  } else {
    // 8 x 32 thread grid, each thread 8 rows x (HD / 32) columns.
    constexpr int kCols = HD / 32;
    const int r0 = (tid / 32) * 8;
    const int c0 = (tid % 32) * kCols;
    float acc[8][kCols];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = os[(r0 + i) * SM::LO + c0 + j];
    for (int t = 0; t < kBlockK; ++t) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = to_f(vs[t * SM::LQ + c0 + j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = to_f(ps[(r0 + i) * SM::LP + t]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] += p * vv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) os[(r0 + i) * SM::LO + c0 + j] = acc[i][j];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ offsets, T* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int window, float scale) {
  using SM = FlashSmem<T, HD>;
  constexpr int kVec = SM::kVec;
  constexpr int kVecPerRow = HD / kVec;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + SM::q_off);
  T* ks = reinterpret_cast<T*>(smem + SM::k_off);
  T* vs = reinterpret_cast<T*>(smem + SM::v_off);
  float* ss = reinterpret_cast<float*>(smem + SM::s_off);
  T* ps = reinterpret_cast<T*>(smem + SM::p_off);
  float* os = reinterpret_cast<float*>(smem + SM::o_off);
  float* m_s = reinterpret_cast<float*>(smem + SM::m_off);
  float* l_s = m_s + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int block_q = kRows / group;  // query positions per CTA
  const int rows_used = block_q * group;
  const int q0 = blockIdx.x * block_q;
  const int off = offsets[b];

  // Live k-block range of this q block.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int last_blk = min((q_last + off) / kBlockK, (kv_len - 1) / kBlockK);
  const int first_blk =
      window < 0 ? 0 : max(q0 + off - window + 1, 0) / kBlockK;

  // Row r holds query position q0 + r / group of query head h*group + r % group.
  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int vec = i % kVecPerRow;
    const int pos = q0 + r / group;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_used && pos < q_len) {
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * q_len + pos) * n_q + h * group + r % group) * HD +
          vec * kVec);
    }
    *reinterpret_cast<uint4*>(qs + r * SM::LQ + vec * kVec) = val;
  }
  for (int i = tid; i < kRows * HD; i += kThreads) {
    os[(i / HD) * SM::LO + i % HD] = 0.f;
  }
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  auto load_tile = [&](T* dst, const T* src, int k0) {
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int vec = i % kVecPerRow;
      T* d = dst + r * SM::LQ + vec * kVec;
      if (k0 + r < kv_len) {
        cp_async16(d, src + ((static_cast<size_t>(b) * kv_len + k0 + r) * n_kv + h) * HD +
                          vec * kVec);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  for (int j = first_blk; j <= last_blk; ++j) {
    const int k0 = j * kBlockK;
    load_tile(ks, k, k0);
    load_tile(vs, v, k0);
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    scores_tile<T, HD>(qs, ks, ss, tid);
    __syncthreads();

    // Online softmax: warp w owns rows [8w, 8w + 8), lanes own columns.
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp * (kRows / kWarps) + rr;
      const int pos = q0 + r / group;
      const bool row_ok = r < rows_used && pos < q_len;
      const int q_abs = pos + off;
      const float m_prev = m_s[r];
      float s[2];
      bool valid[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kp = k0 + lane + 32 * u;
        valid[u] = row_ok && kp <= q_abs && kp < kv_len &&
                   (window < 0 || kp > q_abs - window);
        s[u] = valid[u] ? ss[r * SM::LS + lane + 32 * u] * scale : -INFINITY;
      }
      float m_cur = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      }
      const float m_new = fmaxf(m_prev, m_cur);
      // A row still fully masked keeps m == -inf: pin the rescale to 0
      // (exp(-inf - -inf) is NaN) and subtract 0 instead of m_new.
      const float alpha = m_new == -INFINITY ? 0.f : expf(m_prev - m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = valid[u] ? expf(s[u] - base) : 0.f;
        ps[r * SM::LP + lane + 32 * u] = from_f<T>(p);
        sum += p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int d = lane; d < HD; d += 32) os[r * SM::LO + d] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    pv_tile<T, HD>(ps, vs, os, tid);
    __syncthreads();  // K, V, P are rewritten by the next k-block
  }

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int pos = q0 + r / group;
    if (r < rows_used && pos < q_len) {
      const float l = l_s[r];
      out[((static_cast<size_t>(b) * q_len + pos) * n_q + h * group + r % group) * HD + d] =
          from_f<T>(os[r * SM::LO + d] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* offsets, void* out, int batch, int q_len,
                   int kv_len, int n_q, int n_kv, int window, float scale,
                   cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int block_q = kRows / group;
  const size_t smem = FlashSmem<T, HD>::bytes;
  auto kernel = flash_prefill_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + block_q - 1) / block_q, n_kv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(offsets),
      static_cast<T*>(out), q_len, kv_len, n_q, n_kv, group, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [batch, q_len, n_q, head_dim]; k/v [batch, kv_len, n_kv, head_dim];
// offsets [batch] int32 causal offsets; out like q. window < 0: no sliding
// window. dtype 0 = f32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int kvt_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* offsets, void* out, int batch,
                                 int q_len, int kv_len, int n_q, int n_kv,
                                 int head_dim, int window, float scale,
                                 int dtype, void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kRows || batch <= 0 ||
      q_len <= 0 || kv_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 128 && dtype == 1) {
    err = launch<__nv_bfloat16, 128>(q, k, v, offsets, out, batch, q_len, kv_len, n_q, n_kv, window, scale, s);
  } else if (head_dim == 128 && dtype == 0) {
    err = launch<float, 128>(q, k, v, offsets, out, batch, q_len, kv_len, n_q, n_kv, window, scale, s);
  }
  return static_cast<int>(err);
}
