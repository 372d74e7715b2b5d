// Causal flash attention for chunked prefill on Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the reference package
// (llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:47, reached through
// `flash_prefill` from the serving prefill and packed-prefill paths): q row i
// of batch b attends key positions k <= off[b] + i and k < kv_len, and with a
// sliding window also k > off[b] + i - window. The GQA group is folded into
// the rows of a tile, so the group's query heads share every K/V tile.
// Operands stay in the model dtype with f32 accumulation, the softmax runs
// online in f32, and the probabilities are cast to the V dtype before P @ V,
// as the TPU kernel does. Fully masked rows write zeros.
//
// Bound on this card: operations. A causal 2048 x 2048 chunk with 16 query
// heads of 128 does 17.19 GFLOP per layer call (QK^T and PV over the causal
// half) against ~17 MB of q/k/v/out traffic: 17.4 us at 989 TFLOP/s bf16
// dense, the bytes a third of that.
//
// bf16 design (the serving path). The first port kept scores, probabilities
// and the running output in shared memory: every 16x16 WMMA tile went out to
// shared memory after QK^T, the output accumulator was loaded and stored back
// on every k-block, the online softmax and the alpha rescale were two more
// shared-memory passes, four __syncthreads a k-block, and K/V of block j were
// only requested once block j-1 was done. It ran at ~3% of the bf16 peak.
// Here:
//  - a warpgroup (128 threads) owns 64 tile rows (64 / group query positions
//    x group heads). S = Q K^T is wgmma m64n128k16 with Q and K in shared
//    memory (both K-major: the reduction runs over the contiguous head dim);
//    O += P V is wgmma m64n{HD}k16 with P from registers: the f32 S
//    accumulator, rounded to bf16 in place, already has the A-fragment
//    layout, and V is read MN-major (trans-b) as it lies, [key][hd].
//  - O (64 x HD f32), m and l stay in registers for the whole k-loop, each
//    thread holding two rows; the row max is taken with two quad shuffles,
//    the row sum is kept per thread and reduced once at the end, and the
//    softmax runs in the exp2 domain with log2(e)/sqrt(hd) folded into one
//    scale. Nothing O(rows x keys) touches shared memory.
//  - K and V tiles of 128 keys arrive by cp.async through a two-stage ring,
//    written straight into the 128-byte-swizzled layout that the wgmma
//    descriptors name; block j+1 is in flight while block j computes, and
//    one __syncthreads a k-block hands a stage back. Q is loaded once. Each
//    thread copies fixed 16-byte columns of the tile, so a block's copies
//    cost one pointer add each, and only a tile that crosses kv_len
//    zero-fills.
//  - Only k-blocks that cross a row's causal limit, the window's lower edge
//    or kv_len build a mask; interior blocks take the unmasked path. k-blocks
//    above the diagonal or below the window are neither loaded nor computed.
//  - Tile plan (the launch picks, from the shapes): two warpgroups (128
//    rows, 161 KB of shared memory) a CTA share each K/V tile, halving the
//    bytes every row pulls from L2, wherever that grid still has a CTA for
//    every SM: the 2,048-token chunk (16 q over 8 kv heads) gives 256 CTAs.
//    Otherwise one warpgroup (64 rows): the serving chunk (512 new tokens
//    after 1,024 cached) has 1,024 rows per kv head, 128 CTAs of 64 rows on
//    132 SMs where 128-row CTAs would leave half the card idle. The grid
//    walks the q-blocks heaviest first (most keys), so the causal tail packs
//    into the last wave. 128-key blocks beat 64-key ones on the card (fewer
//    waits and shuffles per key); so did two stages against three, and this
//    serial loop against one that overlaps a block's softmax with the
//    previous block's P V (measured, chip_smoke.py's shapes).
// Not yet done (later work): TMA loads, a producer warp with setmaxnreg,
// two consumer warpgroups in ping-pong behind mbarriers.
//
// The f32 instantiation (checks and small f32 pods) keeps the first port's
// CUDA-core structure: scores, probabilities and output in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 64;  // keys per k-block (both kernels)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
// Copies 16 bytes, or writes 16 zero bytes when `pred` is false (`gmem` is
// then not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16: wgmma with register-resident softmax state.

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // tile rows per warpgroup
constexpr int kWGThreads = 128;
constexpr int kBK = 128;    // keys per k-block
constexpr int kStages = 2;  // K/V ring depth

// Byte offset of 16-byte chunk `c` (0 .. HD/8-1) of row `r` in a bf16 tile
// laid out for wgmma's 128-byte swizzle: the tile is cut into HD/64 column
// panels of [rows][64] (128 bytes a row, `panel` bytes a panel), and chunk c
// of row r of a panel sits at chunk (c % 8) ^ (r % 8) of its row. Panels
// start on 1024-byte boundaries, as the swizzle requires.
__device__ __forceinline__ int swz(int r, int c, int panel) {
  return (c >> 3) * panel + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. lbo and sbo in
// 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a wgmma's registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(r[i][x])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128], B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD, int kWG>
struct Smem {
  static constexpr int kQ = kRows * HD * 2;       // one warpgroup's Q tile, bytes
  static constexpr int kKV = kBK * HD * 2;        // one K or V tile, bytes
  static constexpr int kQPanel = kRows * 128;     // bytes of a 64-column panel of Q
  static constexpr int kKVPanel = kBK * 128;      // ... of K or V
  static constexpr int q_off = 0;                 // kWG Q tiles
  static constexpr int kv_off = kWG * kQ;         // stage s: K at kv_off + 2s kKV, V after it
  static constexpr int bytes = kv_off + kStages * 2 * kKV + 1024;  // + alignment slack
};

// One CTA: kWG warpgroups, each owning 64 of its 64 kWG rows, share every
// K/V tile of kBK keys. Accumulator element i of a thread sits in row
// 8 * ((i / 2) % 2) + lane / 4 of its warp's 16 rows and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int HD, int kWG>
__global__ void __launch_bounds__(kWG * kWGThreads) flash_prefill_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ offsets, int offset, bf16* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int window, float scale_log2) {
  using SM = Smem<HD, kWG>;
  constexpr int kThreads = kWG * kWGThreads;
  constexpr int kChunks = HD / 8;                  // 16-byte chunks per row
  constexpr int kPass = kThreads / kChunks;        // K/V rows one pass of the CTA copies
  constexpr int kAcc = HD / 2;                     // O accumulator floats per thread
  constexpr int kS = kBK / 2;                      // S accumulator floats per thread

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto k_tile = [&](int s) { return SM::kv_off + 2 * s * SM::kKV; };

  const int tid = threadIdx.x;
  const int wgi = tid / kWGThreads;  // this thread's warpgroup
  const int warp = (tid % kWGThreads) >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest q-blocks first
  const int block_q = kWG * kRows / group;    // query positions per CTA
  const int rows_used = block_q * group;
  const int q0 = qb * block_q;
  const int off = offsets != nullptr ? offsets[b] : offset;

  // k-blocks some row of the CTA attends.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int first_blk = (window < 0 ? 0 : max(q0 + off - window + 1, 0)) / kBK;
  const int last_blk = min(q_last + off, kv_len - 1) / kBK;  // < first_blk: none

  // Keys every row of this warpgroup (positions wq0 .. wq1) attends. Both
  // warpgroups walk the CTA's k-blocks; a block none of a warpgroup's rows
  // attends is fully masked for it (at most one at each end).
  const int wq0 = q0 + wgi * kRows / group;
  const int wq1 = min(q0 + (min(wgi * kRows + kRows, rows_used) - 1) / group, q_last);
  const int lo_all = window < 0 ? 0 : wq1 + off - window + 1;
  const int hi_all = min(wq0 + off, kv_len - 1);

  // This thread's two rows: their key range [lo, hi] (hi = -1: dead row).
  int lo[2], hi[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = wgi * kRows + warp * 16 + (lane >> 2) + 8 * u;
    const int pos = q0 + r / group;
    const bool live = r < rows_used && pos < q_len;
    hi[u] = live ? min(pos + off, kv_len - 1) : -1;
    lo[u] = window < 0 ? 0 : pos + off - window + 1;
  }

  // Q tiles, rows in the folded (position, head) order; dead rows zero.
  for (int i = tid; i < kWG * kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int pos = q0 + r / group;
    const bool ok = r < rows_used && pos < q_len;
    const bf16* src =
        ok ? q + ((static_cast<size_t>(b) * q_len + pos) * n_q + h * group + r % group) * HD +
                 c * 8
           : q;
    cp_async16_zfill(smem + SM::q_off + (r / kRows) * SM::kQ + swz(r % kRows, c, SM::kQPanel),
                     src, ok);
  }
  // K/V: thread tid copies chunk tid % kChunks of rows tid / kChunks + kPass i.
  const int lrow = tid / kChunks;
  const size_t key_stride = static_cast<size_t>(n_kv) * HD;  // elements from key to key
  const size_t g_thread = (static_cast<size_t>(b) * kv_len + lrow) * key_stride + h * HD +
                          (tid % kChunks) * 8;
  const int s_thread = swz(lrow, tid % kChunks, SM::kKVPanel);
  auto load_kv = [&](int j, int s) {
    const int key0 = j * kBK;
    const bf16* kg = k + g_thread + key0 * key_stride;
    const bf16* vg = v + g_thread + key0 * key_stride;
    unsigned char* ks = smem + k_tile(s) + s_thread;
    const bool full = key0 + kBK <= kv_len;
#pragma unroll
    for (int i = 0; i < kBK / kPass; ++i) {
      const size_t g = i * kPass * key_stride;
      if (full) {
        cp_async16(ks + i * kPass * 128, kg + g);
        cp_async16(ks + SM::kKV + i * kPass * 128, vg + g);
      } else {
        const bool ok = key0 + lrow + i * kPass < kv_len;
        cp_async16_zfill(ks + i * kPass * 128, ok ? kg + g : k, ok);
        cp_async16_zfill(ks + SM::kKV + i * kPass * 128, ok ? vg + g : v, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q rides in the first group
    if (first_blk + s <= last_blk) load_kv(first_blk + s, s);
    cp_async_commit();
  }

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  const uint32_t q_base = base + SM::q_off + wgi * SM::kQ;

  // No branch may skip a wgmma inside this loop: the compiler would then
  // serialize every wgmma of the kernel.
  for (int j = first_blk; j <= last_blk; ++j) {
    const int it = j - first_blk;
    const int stage = it % kStages;
    cp_async_wait<kStages - 2>();  // block j (and Q) landed for this thread
    fence_proxy_async();           // ... and is visible to wgmma's reads
    __syncthreads();               // for every thread; block j-1's stage is free
    if (j + kStages - 1 <= last_blk) load_kv(j + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int k0 = j * kBK;

    // S = Q K^T over the head dim, 16 at a time.
    float s[kS];
    const uint32_t k_base = base + k_tile(stage);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t dq = (kk >> 2) * SM::kQPanel + (kk & 3) * 32;
      const uint32_t dk = (kk >> 2) * SM::kKVPanel + (kk & 3) * 32;
      wgmma_ss(s, make_desc(q_base + dq, 1, 64), make_desc(k_base + dk, 1, 64), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Interior blocks are valid for every row: no mask.
    const bool interior = k0 + kBK - 1 <= hi_all && k0 >= lo_all;
    if (!interior) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int u = (i >> 1) & 1;
        const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (kp > hi[u] || kp < lo[u]) s[i] = -INFINITY;
      }
    }

    // Online softmax in the exp2 domain; each row lives in a quad of lanes.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], shift[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u] * scale_log2);
      // A row still fully masked keeps m == -inf: pin the rescale to 0
      // (-inf - -inf is NaN) and shift by 0 instead of m_new.
      alpha[u] = m_new == -INFINITY ? 0.f : exp2_approx(m[u] - m_new);
      shift[u] = m_new == -INFINITY ? 0.f : m_new;
      m[u] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int u = (i >> 1) & 1;
      s[i] = exp2_approx(fmaf(s[i], scale_log2, -shift[u]));
      sum[u] += s[i];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = alpha[u] * l[u] + sum[u];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P in bf16 as wgmma A fragments: k-step kk takes S columns 16kk..16kk+15.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }

    // O += P V; the V tile [key][hd] is MN-major for this product, its
    // 64-column panels kKVPanel bytes apart.
    const uint32_t v_base = k_base + SM::kKV;
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs(o, pa[kk], make_desc(v_base + kk * 16 * 128, SM::kKVPanel / 16, 64));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // Epilogue: reduce l over the quad, normalize, store bf16 pairs.
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const int r = wgi * kRows + warp * 16 + (lane >> 2) + 8 * u;
    const int pos = q0 + r / group;
    if (r >= rows_used || pos >= q_len) continue;
    const float inv = l[u] == 0.f ? 0.f : 1.f / l[u];  // no valid key: O is 0
    bf16* dst = out + ((static_cast<size_t>(b) * q_len + pos) * n_q + h * group + r % group) * HD +
                2 * (lane & 3);
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n8) =
          __floats2bfloat162_rn(o[4 * n8 + 2 * u] * inv, o[4 * n8 + 2 * u + 1] * inv);
    }
  }
}

template <int HD, int kWG>
cudaError_t launch_wg(const void* q, const void* k, const void* v, const void* offsets,
                      int offset, void* out, int batch, int q_len, int kv_len, int n_q, int n_kv,
                      int window, float scale, cudaStream_t stream) {
  const int block_q = kWG * kRows / (n_q / n_kv);
  const int smem = Smem<HD, kWG>::bytes;
  auto kernel = flash_prefill_wgmma_kernel<HD, kWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_kv, batch, (q_len + block_q - 1) / block_q);
  kernel<<<grid, kWG * kWGThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(offsets), offset, static_cast<bf16*>(out), q_len, kv_len, n_q, n_kv,
      n_q / n_kv, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Tile plan: two warpgroups (128 rows) a CTA halve the K/V traffic from L2
// per row, where the 128-row grid still covers every SM; else one (64 rows),
// so that short chunks fill the card.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets, int offset,
                   void* out, int batch, int q_len, int kv_len, int n_q, int n_kv, int window,
                   float scale, cudaStream_t stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int block_q2 = 2 * kRows / (n_q / n_kv);
  const long ctas2 = static_cast<long>((q_len + block_q2 - 1) / block_q2) * n_kv * batch;
  if (ctas2 >= n_sm) {
    return launch_wg<HD, 2>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv,
                            window, scale, stream);
  }
  return launch_wg<HD, 1>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, window,
                          scale, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, scores / probabilities / output in shared memory.

namespace f32 {

constexpr int kRows = 64;  // q rows per CTA (positions x group heads)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory plan, rows padded by 16 bytes against bank conflicts.
template <int HD>
struct FlashSmem {
  static constexpr int LQ = HD + 4;        // q/k/v rows, floats
  static constexpr int LS = kBlockK + 4;   // score and probability rows
  static constexpr int LO = HD + 4;        // output accumulator rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * kRows * LQ;
  static constexpr size_t v_off = k_off + sizeof(float) * kBlockK * LQ;
  static constexpr size_t s_off = v_off + sizeof(float) * kBlockK * LQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kRows * LS;
  static constexpr size_t o_off = p_off + sizeof(float) * kRows * LS;
  static constexpr size_t m_off = o_off + sizeof(float) * kRows * LO;
  static constexpr size_t bytes = m_off + sizeof(float) * 2 * kRows;
};

// S[kRows][kBlockK] = Q[kRows][HD] @ K[kBlockK][HD]^T (unscaled); a 16 x 16
// thread grid, each thread a 4 x 4 block of scores.
template <int HD>
__device__ __forceinline__ void scores_tile(const float* qs, const float* ks, float* ss,
                                            int tid) {
  using SM = FlashSmem<HD>;
  const int r0 = (tid / 16) * 4;
  const int c0 = (tid % 16) * 4;
  float acc[4][4] = {};
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(r0 + i) * SM::LQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(c0 + j) * SM::LQ + d];
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

// O[kRows][HD] += P[kRows][kBlockK] @ V[kBlockK][HD]; an 8 x 32 thread grid,
// each thread 8 rows x (HD / 32) columns.
template <int HD>
__device__ __forceinline__ void pv_tile(const float* ps, const float* vs, float* os, int tid) {
  using SM = FlashSmem<HD>;
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
    for (int j = 0; j < kCols; ++j) vv[j] = vs[t * SM::LQ + c0 + j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = ps[(r0 + i) * SM::LS + t];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] += p * vv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) os[(r0 + i) * SM::LO + c0 + j] = acc[i][j];
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ offsets, int offset, float* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int window, float scale) {
  using SM = FlashSmem<HD>;
  constexpr int kVec = 4;  // floats per 16-byte copy
  constexpr int kVecPerRow = HD / kVec;

  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + SM::q_off);
  float* ks = reinterpret_cast<float*>(smem + SM::k_off);
  float* vs = reinterpret_cast<float*>(smem + SM::v_off);
  float* ss = reinterpret_cast<float*>(smem + SM::s_off);
  float* ps = reinterpret_cast<float*>(smem + SM::p_off);
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
  const int off = offsets != nullptr ? offsets[b] : offset;

  // Live k-block range of this q block.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int last_blk = min((q_last + off) / kBlockK, (kv_len - 1) / kBlockK);
  const int first_blk = window < 0 ? 0 : max(q0 + off - window + 1, 0) / kBlockK;

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
  for (int i = tid; i < kRows * HD; i += kThreads) os[(i / HD) * SM::LO + i % HD] = 0.f;
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  auto load_tile = [&](float* dst, const float* src, int k0) {
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int vec = i % kVecPerRow;
      float* d = dst + r * SM::LQ + vec * kVec;
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

    scores_tile<HD>(qs, ks, ss, tid);
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
        valid[u] = row_ok && kp <= q_abs && kp < kv_len && (window < 0 || kp > q_abs - window);
        s[u] = valid[u] ? ss[r * SM::LS + lane + 32 * u] * scale : -INFINITY;
      }
      float m_cur = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o; o >>= 1) m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_new = fmaxf(m_prev, m_cur);
      // A row still fully masked keeps m == -inf: pin the rescale to 0
      // (exp(-inf - -inf) is NaN) and subtract 0 instead of m_new.
      const float alpha = m_new == -INFINITY ? 0.f : expf(m_prev - m_new);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = valid[u] ? expf(s[u] - base) : 0.f;
        ps[r * SM::LS + lane + 32 * u] = p;
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

    pv_tile<HD>(ps, vs, os, tid);
    __syncthreads();  // K, V, P are rewritten by the next k-block
  }

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i % HD;
    const int pos = q0 + r / group;
    if (r < rows_used && pos < q_len) {
      const float l = l_s[r];
      out[((static_cast<size_t>(b) * q_len + pos) * n_q + h * group + r % group) * HD + d] =
          os[r * SM::LO + d] / (l == 0.f ? 1.f : l);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets, int offset,
                   void* out, int batch, int q_len, int kv_len, int n_q, int n_kv, int window,
                   float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int block_q = kRows / group;
  const size_t smem = FlashSmem<HD>::bytes;
  auto kernel = flash_prefill_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + block_q - 1) / block_q, n_kv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(offsets), offset, static_cast<float*>(out), q_len, kv_len, n_q,
      n_kv, group, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// q [batch, q_len, n_q, head_dim]; k/v [batch, kv_len, n_kv, head_dim];
// offsets [batch] int32 causal offsets on the device, or null for one
// `offset` shared by every batch row; out like q. window < 0: no sliding
// window. dtype 0 = f32 (head_dim 128), 1 = bf16 (head_dim 64 or 128).
// Returns the launch's cudaError_t.
extern "C" int kvt_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* offsets, int offset, void* out, int batch,
                                 int q_len, int kv_len, int n_q, int n_kv, int head_dim,
                                 int window, float scale, int dtype, void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 64 || batch <= 0 || q_len <= 0 ||
      kv_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) {
    err = wg::launch<128>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, window,
                          scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = wg::launch<64>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, window,
                         scale, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = f32::launch<128>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, window,
                           scale, s);
  }
  return static_cast<int>(err);
}
