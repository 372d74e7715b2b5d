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
// two consumer warpgroups in ping-pong behind mbarriers (the head dims above
// 256 have the producer warpgroup and the mbarriers: below).
//
// f32 design (f32 pods and the checks; namespace f32). The FMAs are f32 on
// the CUDA cores: TF32 would round the operands to a 10-bit mantissa, which
// an f32 result cannot carry. Bound on this card: operations, at 67 TFLOP/s
// outside the tensor cores (the serving chunk's 5.37 GFLOP: 0.080 ms). The
// first port's f32 body kept S, P and O in shared memory, loaded every
// operand there one float at a time, passed four barriers a k-block and
// requested block j + 1 only once block j was done: 11-12 TFLOP/s on an
// H100. Here, up to head_dim 256 (`flash_prefill_f32_kernel`):
//  - 8 warps own the CTA's 64 rows. Up to 128 two warps share a row group
//    of 16 rows, each taking one half of every 128-key block with its own
//    m, l and O (the halves merge once, after the last block); at 256 the
//    blocks are 64 keys and a warp owns 8 rows. So a warp's rows are whole
//    in it: the row max takes three or four shuffles, and P goes from S's
//    lanes to O's through the warp's own rows of shared memory.
//  - Both products are register-tiled, on different lane grids: of S a lane
//    holds 4 rows by 8 keys (4 by 4 at 256), of O 8 rows by 8 columns (4 at
//    64), the whole k-loop. Q, K and V lie in shared memory with rows
//    padded by 4 floats, so every 16-byte load of a warp takes the fewest
//    wavefronts its bytes allow; a float loaded feeds 2.67 FMAs in S and 4
//    in P V. The online softmax runs on registers in the exp2 domain with
//    log2(e)/sqrt(hd) folded into one scale; O is rescaled in registers by
//    its rows' alpha, read back from shared memory beside P.
//  - K and V have a buffer each: V of block j is requested at the block's
//    first barrier and lands while S runs, K of block j + 1 at its second
//    and lands while P V runs (a block of 128 keys has two handoffs: one a
//    64 keys). Each thread copies fixed 16-byte columns, one pointer step a
//    copy, where a row is the padded width. 206 KB of shared memory at HD
//    128 leaves one CTA an SM: the serving chunk has 128 CTAs for 132 SMs,
//    so a second slot would stand empty there, and the room goes to
//    128-key blocks, which give each lane of S twice the keys of 64-key
//    blocks.
//  - Only the keys of a block that cross one of the row group's limits are
//    masked; blocks above the diagonal or below the window are neither
//    loaded nor computed; the grid walks the heaviest q-blocks first.
// It runs at 2.5-3x the first port's rate on an H100 (28.8-31.6 TFLOP/s,
// 43-47% of the f32 rate). The likely limit is the shared-memory load
// pipe: if an LDS.128 returns 512 bytes a warp whatever its broadcast, S at
// 2.67 FMAs a float waits on it. 4 FMAs a float would take 8 x 8 tiles of S
// a lane, so 256-key blocks at 64 rows a CTA: 270 KB of f32 K and V at
// head_dim 128, past the 227 KB a CTA can have.
//
// Head dims: both kernels are built at the padded widths 64, 128 and 256
// (HD) and take the true head_dim (hd, any >= 1) at run time. At hd == HD
// (64, 128, 256) the tiles load in 16-byte chunks as above. Below it (50,
// 80, 96, 100, ...) a global row of q, k or v starts only 8, 4 or 2-byte
// aligned (a bf16 row of 100 is 200 bytes), so each row is loaded in pieces
// of the largest size its byte width allows (`row_piece`: 16, 8 or 4 bytes
// by cp.async, which zero-fills the padded columns from a source size of 0;
// 2 bytes by plain loads and stores), into the same padded tile. The padded
// columns are zero in Q and K, so the k-steps of 16 over them add nothing
// to a score, the P V product runs at the padded width, and only the true
// columns are stored. At HD 256 the bf16 tiles are 64 keys (kBK): two
// warpgroups' Q (64 KB) and two stages of K and V (128 KB) fit shared
// memory, and O (128 f32 a thread) is two m64n128 products a k-step.
//
// Above 256 (288, 300, 512, 576, 1,024, ...) neither fits: at hd 512 one
// warpgroup's Q (64 KB) and two stages of 64-key K/V tiles (128 KB each)
// need 320 KB of shared memory, and O of 64 x 512 f32 is 256 registers a
// thread. The bf16 kernel (`flash_prefill_wide_kernel`) cuts the head dim
// into P = n_panels(hd) panels of 256 columns (row_copy.cuh) over a
// thread-block cluster of P x key_splits CTAs per query tile of 64 rows:
//  - CTA (panel p, split s) keeps Q's panel p resident (32 KB, loaded once)
//    and owns O's slab p (an m64n256 accumulator as two m64n128 products,
//    128 f32 registers a thread). Per 64-key block of its split it computes
//    its panel's share of S = Q K^T (m64n64, 16 k-steps) and exchanges it
//    with the other panel CTAs: up to 3 panels it pushes its share into
//    each peer's slot by st.async, whose bytes complete the peer's
//    "exchange full" mbarrier (the peer's thread 0 expects them), two
//    buffers by block parity; above 3 (the slots would outgrow shared
//    memory) it writes its share to its own buffer, arrives on every
//    peer's barrier with release at cluster scope, and the peers read it
//    through distributed shared memory. Every panel CTA adds the shares in
//    panel order (its own from registers), so each holds the same S, m and
//    l. Then mask, online softmax and O += P V on its own V slab. S is
//    computed once per (query tile, key block): the P CTAs' products add up
//    to one QK^T over the head dim, and each K and V byte is read once per
//    query tile (panel p's columns by CTA p only).
//  - Two warpgroups a CTA: warpgroup 0 computes; warpgroup 1 loads, each
//    block's K panel and V slab (32 KB each) into a two-stage ring by
//    cp.async in `row_piece` pieces straight into the 128-byte swizzle
//    (a bulk copy cannot swizzle, and a tensor map needs 16-byte row
//    strides that hd 257 and 300 lack), each thread arriving on the
//    stage's "full" mbarrier through cp.async.mbarrier.arrive once its
//    copies land, so the loaders run a stage ahead without waiting; the
//    computing warpgroup fences the async proxy after its wait, and
//    arrives on the stage's "empty" mbarrier after its last wgmma of the
//    block. With one computing warpgroup the CTA's 256 threads get 255
//    registers each without setmaxnreg.
//  - Key splits fill the card: the serving chunk (L = 512 at offset 1,024,
//    4/2 heads of 512) has 32 query tiles x 2 panels; key_splits = 2
//    (ops/flash_prefill.py `wide_plan`: the most, with the cluster at most
//    the portable 8, that keep one CTA per SM) gives 128 CTAs. Split s walks
//    a contiguous share of the tile's key blocks; after the loop each CTA
//    leaves its slab's unnormalized O, m and l in its stages, and after a
//    cluster barrier rank (p, s) merges rows s * 64 / splits .. of slab p
//    from every split, in split order (no atomics).
// Above 2,048 the panels outgrow the portable cluster of 8, and the bf16
// kernel is `flash_prefill_panel_kernel`: one warpgroup a CTA, a CTA per
// slab of O, walking Q's and K's panels through a two-stage ring of P + 1
// stages a 64-key block (S accumulates over the panels in registers), then
// V's slab. It reads Q again from L2 each block and K once a slab, and
// computes S once a slab. Above 256 the f32 kernel is
// `flash_prefill_f32_panel_kernel`: a CTA a slab of O, S over every panel
// (so S is computed once a slab: 1.5x the FLOPs at 512), 32-key K panels
// and V's slab streamed through a ring of two slots with a barrier a tile,
// Q's two panels resident at 512 and streamed beside K's above, the lane
// grids of the HD-256 plan. Every head dim runs in both dtypes.
//
// GQA: a group of g query heads folds into a tile's rows as (position, head)
// pairs, floor(R / gc) positions a CTA of R = 64 or 128 rows (a group of 7:
// 9 positions in 63 of 64 rows, or 18 in 126 of 128; the rest are dead rows),
// where gc = g up to R; a larger group is split into ceil(g / R) chunks of
// gc = ceil(g / chunks) heads, one CTA column of the grid's head axis each
// (`head_chunk`; group 71 over 64 rows: 36 + 35 heads, one position a CTA).
// A warpgroup's 64 rows may then split a position's heads between the two
// warpgroups of a CTA; each warpgroup's key range covers every position it
// holds a row of.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_copy.cuh"  // padded, row_piece, with_piece, copy_piece, cp_async*

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Query heads a CTA of `rows` tile rows takes of a GQA group: the whole
// group up to `rows`, else an even share of ceil(group / rows) chunks.
__host__ __device__ constexpr int head_chunk(int group, int rows) {
  return group <= rows ? group : (group + (group + rows - 1) / rows - 1) / ((group + rows - 1) / rows);
}

// ---------------------------------------------------------------------------
// bf16: wgmma with register-resident softmax state.

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // tile rows per warpgroup
constexpr int kWGThreads = 128;
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
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
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

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
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

// The pieces of a k-block that both bf16 kernels share. A thread's S
// accumulator (kS floats of an m64nN product) holds, at element i, key
// 8 (i / 4) + 2 (lane % 4) + i % 2 of the block for row-half u = (i / 2) % 2
// (rows lane / 4 and lane / 4 + 8 of its warp's 16); O (kOut products of
// kAcc floats) the same way over columns.

// Keys outside a row's [lo, hi] get -inf (k0: the block's first key).
template <int kS>
__device__ __forceinline__ void mask_block(float (&s)[kS], int k0, int lane, const int (&lo)[2],
                                           const int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int u = (i >> 1) & 1;
    const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (kp > hi[u] || kp < lo[u]) s[i] = -INFINITY;
  }
}

// Online softmax in the exp2 domain; each row lives in a quad of lanes. s
// (raw scores) becomes the probabilities; m (running max, log2 domain) and
// l (this thread's share of the row sum) update, and O is rescaled.
template <int kS, int kOut, int kAcc>
__device__ __forceinline__ void online_softmax(float (&s)[kS], float (&m)[2], float (&l)[2],
                                               float (&o)[kOut][kAcc], float scale_log2) {
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
  for (int x = 0; x < kOut; ++x)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[x][i] *= alpha[(i >> 1) & 1];
}

// P in bf16 as wgmma A fragments: k-step kk takes S columns 16kk..16kk+15.
template <int kS>
__device__ __forceinline__ void pack_probs(const float (&s)[kS], uint32_t (&pa)[kS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kS / 8; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
  }
}

// Row-half u of O times inv, as bf16 pairs, to the output row at `row` (hd
// columns): O's column c goes to column col0 + c, only those below hd.
template <int kOut, int kAcc>
__device__ __forceinline__ void store_row(bf16* row, const float (&o)[kOut][kAcc], int u,
                                          float inv, int hd, int col0, int lane) {
  bf16* dst = row + col0 + 2 * (lane & 3);
  constexpr int kN8 = kAcc / 4;  // 8-column groups of one product
#pragma unroll
  for (int n8 = 0; n8 < kOut * kN8; ++n8) {
    const float lo = o[n8 / kN8][4 * (n8 % kN8) + 2 * u] * inv;
    const float hi = o[n8 / kN8][4 * (n8 % kN8) + 2 * u + 1] * inv;
    const int col = col0 + 8 * n8 + 2 * (lane & 3);
    if (hd % 2 == 0) {  // rows and pairs 4-byte aligned
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n8) = __floats2bfloat162_rn(lo, hi);
      }
    } else {
      if (col < hd) dst[8 * n8] = __float2bfloat16(lo);
      if (col + 1 < hd) dst[8 * n8 + 1] = __float2bfloat16(hi);
    }
  }
}

template <int HD, int kWG>
struct Smem {
  static constexpr int kBK = HD > 128 ? 64 : 128;  // keys per k-block
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
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 (O at HD 256: two products of 128
// columns, o[1] the second's).
template <int HD, int kWG>
__global__ void __launch_bounds__(kWG * kWGThreads) flash_prefill_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ offsets, int offset, bf16* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int gc, int hd, int window, float scale_log2) {
  using SM = Smem<HD, kWG>;
  constexpr int kBK = SM::kBK;
  constexpr int kThreads = kWG * kWGThreads;
  constexpr int kChunks = HD / 8;                  // 16-byte chunks per row
  constexpr int kPass = kThreads / kChunks;        // K/V rows one pass of the CTA copies
  constexpr int kOut = HD > 128 ? 2 : 1;           // P V products (128 columns at most each)
  constexpr int kAcc = HD / 2 / kOut;              // O accumulator floats per product
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
  // Grid x is (kv head, chunk of gc query heads); head0 is the chunk's
  // first query head, hc the heads it has (the last chunk may have fewer).
  const int n_gc = (group + gc - 1) / gc;
  const int h = blockIdx.x / n_gc;
  const int head0 = h * group + (blockIdx.x % n_gc) * gc;
  const int hc = min(gc, (h + 1) * group - head0);
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest q-blocks first
  const int block_q = kWG * kRows / gc;       // query positions per CTA
  const int rows_used = block_q * gc;
  const int q0 = qb * block_q;
  const int off = offsets != nullptr ? offsets[b] : offset;
  const int row_bytes = hd * 2;

  // k-blocks some row of the CTA attends.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int first_blk = (window < 0 ? 0 : max(q0 + off - window + 1, 0)) / kBK;
  const int last_blk = min(q_last + off, kv_len - 1) / kBK;  // < first_blk: none

  // Keys every row of this warpgroup (positions wq0 .. wq1) attends. Both
  // warpgroups walk the CTA's k-blocks; a block none of a warpgroup's rows
  // attends is fully masked for it (at most one at each end).
  const int wq0 = q0 + wgi * kRows / gc;
  const int wq1 = min(q0 + (min(wgi * kRows + kRows, rows_used) - 1) / gc, q_last);
  const int lo_all = window < 0 ? 0 : wq1 + off - window + 1;
  const int hi_all = min(wq0 + off, kv_len - 1);

  // This thread's two rows: their key range [lo, hi] (hi = -1: dead row).
  int lo[2], hi[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = wgi * kRows + warp * 16 + (lane >> 2) + 8 * u;
    const int pos = q0 + r / gc;
    const bool live = r < rows_used && pos < q_len && r % gc < hc;
    hi[u] = live ? min(pos + off, kv_len - 1) : -1;
    lo[u] = window < 0 ? 0 : pos + off - window + 1;
  }

  // Q tiles, rows in the folded (position, head) order; dead rows zero.
  if (hd == HD) {
    for (int i = tid; i < kWG * kRows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int pos = q0 + r / gc;
      const bool ok = r < rows_used && pos < q_len && r % gc < hc;
      const bf16* src =
          ok ? q + ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * HD + c * 8
             : q;
      cp_async16_zfill(smem + SM::q_off + (r / kRows) * SM::kQ + swz(r % kRows, c, SM::kQPanel),
                       src, ok);
    }
  } else {
    // Unpadded rows: pieces of G bytes, zero past the row's hd columns.
    with_piece<2>(row_bytes, [&](auto piece) {
      constexpr int G = decltype(piece)::value;
      constexpr int kPieces = HD * 2 / G;  // pieces of a padded row
      for (int i = tid; i < kWG * kRows * kPieces; i += kThreads) {
        const int r = i / kPieces;
        const int w = i % kPieces;
        const int pos = q0 + r / gc;
        const bool ok = r < rows_used && pos < q_len && r % gc < hc && w * G < row_bytes;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            ok ? q + ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * hd : q);
        copy_piece<G>(smem + SM::q_off + (r / kRows) * SM::kQ +
                          swz(r % kRows, w * G / 16, SM::kQPanel) + w * G % 16,
                      src + w * G, ok);
      }
    });
  }
  // K/V: thread tid copies chunk tid % kChunks of rows tid / kChunks + kPass i
  // (kPass is 4 at HD 256 with one warpgroup: the swizzle of each row is its
  // own).
  const int lrow = tid / kChunks;
  const size_t key_stride = static_cast<size_t>(n_kv) * hd;  // elements from key to key
  const size_t g_thread = (static_cast<size_t>(b) * kv_len + lrow) * key_stride + h * HD +
                          (tid % kChunks) * 8;
  auto load_kv = [&](int j, int s) {
    const int key0 = j * kBK;
    if (hd != HD) {
      // Unpadded rows: pieces of G bytes, zero past hd and past kv_len.
      with_piece<2>(row_bytes, [&](auto piece) {
        constexpr int G = decltype(piece)::value;
        constexpr int kPieces = HD * 2 / G;
        for (int i = tid; i < kBK * kPieces; i += kThreads) {
          const int key = i / kPieces;
          const int w = i % kPieces;
          const bool ok = key0 + key < kv_len && w * G < row_bytes;
          const size_t g =
              ((static_cast<size_t>(b) * kv_len + key0 + key) * n_kv + h) * hd * 2 + w * G;
          unsigned char* d = smem + k_tile(s) + swz(key, w * G / 16, SM::kKVPanel) + w * G % 16;
          copy_piece<G>(d, reinterpret_cast<const unsigned char*>(k) + (ok ? g : 0), ok);
          copy_piece<G>(d + SM::kKV, reinterpret_cast<const unsigned char*>(v) + (ok ? g : 0),
                        ok);
        }
      });
      return;
    }
    const bf16* kg = k + g_thread + key0 * key_stride;
    const bf16* vg = v + g_thread + key0 * key_stride;
    unsigned char* ks = smem + k_tile(s);
    const bool full = key0 + kBK <= kv_len;
#pragma unroll
    for (int i = 0; i < kBK / kPass; ++i) {
      const size_t g = i * kPass * key_stride;
      const int d = swz(lrow + i * kPass, tid % kChunks, SM::kKVPanel);
      if (full) {
        cp_async16(ks + d, kg + g);
        cp_async16(ks + SM::kKV + d, vg + g);
      } else {
        const bool ok = key0 + lrow + i * kPass < kv_len;
        cp_async16_zfill(ks + d, ok ? kg + g : k, ok);
        cp_async16_zfill(ks + SM::kKV + d, ok ? vg + g : v, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q rides in the first group
    if (first_blk + s <= last_blk) load_kv(first_blk + s, s);
    cp_async_commit();
  }

  float o[kOut][kAcc];
#pragma unroll
  for (int x = 0; x < kOut; ++x)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[x][i] = 0.f;
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
    if (!interior) mask_block(s, k0, lane, lo, hi);
    online_softmax(s, m, l, o, scale_log2);
    uint32_t pa[kBK / 16][4];
    pack_probs(s, pa);

    // O += P V; the V tile [key][hd] is MN-major for this product, its
    // 64-column panels kKVPanel bytes apart (at HD 256, product x takes
    // panels 2x and 2x + 1).
    const uint32_t v_base = k_base + SM::kKV;
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < kOut; ++x) {
        wgmma_rs(o[x], pa[kk],
                 make_desc(v_base + x * 2 * SM::kKVPanel + kk * 16 * 128, SM::kKVPanel / 16, 64));
      }
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
    const int pos = q0 + r / gc;
    if (r >= rows_used || pos >= q_len || r % gc >= hc) continue;
    const float inv = l[u] == 0.f ? 0.f : 1.f / l[u];  // no valid key: O is 0
    store_row(out + ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * hd, o, u,
              inv, hd, 0, lane);
  }
}

template <int HD, int kWG>
cudaError_t launch_wg(const void* q, const void* k, const void* v, const void* offsets,
                      int offset, void* out, int batch, int q_len, int kv_len, int n_q, int n_kv,
                      int hd, int window, float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int gc = head_chunk(group, kWG * kRows);
  const int block_q = kWG * kRows / gc;
  const int smem = Smem<HD, kWG>::bytes;
  auto kernel = flash_prefill_wgmma_kernel<HD, kWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_kv * ((group + gc - 1) / gc), batch, (q_len + block_q - 1) / block_q);
  kernel<<<grid, kWG * kWGThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(offsets), offset, static_cast<bf16*>(out), q_len, kv_len, n_q, n_kv,
      group, gc, hd, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Tile plan: two warpgroups (128 rows) a CTA halve the K/V traffic from L2
// per row, where the 128-row grid still covers every SM; else one (64 rows),
// so that short chunks fill the card.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets, int offset,
                   void* out, int batch, int q_len, int kv_len, int n_q, int n_kv, int hd,
                   int window, float scale, cudaStream_t stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int group = n_q / n_kv;
  const int gc2 = head_chunk(group, 2 * kRows);
  const int block_q2 = 2 * kRows / gc2;
  const long ctas2 = static_cast<long>((q_len + block_q2 - 1) / block_q2) * n_kv *
                     ((group + gc2 - 1) / gc2) * batch;
  if (ctas2 >= n_sm) {
    return launch_wg<HD, 2>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, hd,
                            window, scale, stream);
  }
  return launch_wg<HD, 1>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, hd,
                          window, scale, stream);
}

// Head dims above 256, bf16 (the note at the top): a thread-block cluster
// of n_panels(hd) x key_splits CTAs per query tile of 64 rows. Rank r of the
// cluster holds panel pan = r % n_pan of the head dim (its columns pan *
// 256 .. pan * 256 + 255 of Q, K, V and O) over key split r / n_pan. A CTA
// is two warpgroups: warpgroup 0 computes, warpgroup 1 loads.
struct WideSmem {
  using Tile = Smem<kPanel, 1>;  // the HD-256 layouts: 64-key blocks, Q and K/V tiles
  static constexpr int kBK = Tile::kBK;
  static constexpr int kStages = 2;
  static constexpr int kStage = 2 * Tile::kKV;  // K's panel, then V's, of one block
  static constexpr int kX = 32 * kWGThreads * 4;  // one S partial: 32 floats a consumer thread
  // Up to kPushPanels panels the peers push their shares into this CTA's
  // slots (two buffers of n_pan - 1); above, each CTA's share stays in its
  // own buffer (two) for the peers to read.
  static constexpr int kPushPanels = 3;
  static constexpr int stage_off = Tile::kQ;      // after Q's panel (resident)
  static constexpr int x_off = stage_off + kStages * kStage;  // exchange buffers
  static constexpr int bar_off = x_off + 2 * (kPushPanels - 1) * kX;  // full, empty, xfull, xempty: [2] each
  static constexpr int bytes = bar_off + 8 * 8 + 1024;  // + alignment slack
  // After the k-loop, with key_splits > 1, the stages hold the CTA's
  // partial: O [kRows][kPanel] f32, then m [kRows] (log2 domain), l [kRows].
  static constexpr int kPartFloats = kRows * kPanel + 2 * kRows;
  static_assert(kPartFloats * 4 <= kStages * kStage, "the partial fits the stages");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// One arrival on the barrier at `bar` (this CTA's shared address) in the
// cluster's CTA `cta`, releasing this thread's writes to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// This thread's arrival on `bar`, and `bytes` more of asynchronous writes
// (st.async complete_tx) that the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// 16 bytes to this CTA's shared address `addr` in the cluster's CTA `cta`,
// completing 16 bytes of the transaction on that CTA's barrier at `bar`
// (this CTA's shared address of it).
__device__ __forceinline__ void st_async16(uint32_t addr, uint32_t bar, int cta, float4 x) {
  asm volatile(
      "{\n .reg .b32 ra, rb;\n mapa.shared::cluster.u32 ra, %0, %2;\n"
      " mapa.shared::cluster.u32 rb, %1, %2;\n"
      " st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [ra], {%3, %4, %5, %6}, [rb];\n}\n"
      ::"r"(addr), "r"(bar), "r"(cta), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
      : "memory");
}
// Wait for phase `parity` of the barrier at `bar`; kCluster: acquire the
// writes that the cluster's arrivals released. A wait that never ends (a
// broken protocol) traps after about 2^30 polls, a launch failure the
// wrapper reports, instead of holding the card.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    if constexpr (kCluster) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    }
  }
}

__global__ void __launch_bounds__(2 * kWGThreads, 1) flash_prefill_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ offsets, int offset, bf16* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int gc, int hd, int window, float scale_log2) {
  using WS = WideSmem;
  using SM = WS::Tile;
  constexpr int kBK = WS::kBK;     // 64 keys a block
  constexpr int kAcc = kPanel / 4;  // O floats of one m64n128 product
  constexpr int kS = kBK / 2;      // S accumulator floats per thread
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + WS::bar_off;  // K/V of a stage landed (128 loader arrivals)
  const uint32_t empty0 = full0 + 16;          // a stage consumed (4 warp arrivals)
  const uint32_t xfull0 = empty0 + 16;         // every panel's S partial of a block written
  const uint32_t xempty0 = xfull0 + 16;        // every panel read this CTA's S partial

  const int tid = threadIdx.x;
  const int wgi = tid / kWGThreads;
  const int warp = (tid % kWGThreads) >> 5;
  const int lane = tid & 31;
  const int n_pan = n_panels(hd);
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n_split = csize / n_pan;
  const int rank = static_cast<int>(cluster.block_rank());
  const int pan = rank % n_pan;
  const int split = rank / n_pan;
  // Grid x is ((kv head, chunk of gc query heads), cluster rank).
  const int n_gc = (group + gc - 1) / gc;
  const int hx = blockIdx.x / csize;
  const int h = hx / n_gc;
  const int head0 = h * group + (hx % n_gc) * gc;
  const int hc = min(gc, (h + 1) * group - head0);
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest q-blocks first
  const int block_q = kRows / gc;             // query positions per CTA
  const int rows_used = block_q * gc;
  const int q0 = qb * block_q;
  const int off = offsets != nullptr ? offsets[b] : offset;
  const int row_bytes = hd * 2;
  const int col0 = pan * kPanel * 2;  // the panel's first byte in a row

  // k-blocks some row attends, and the keys every row attends; this
  // split's share of the blocks.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int first_blk = (window < 0 ? 0 : max(q0 + off - window + 1, 0)) / kBK;
  const int last_blk = min(q_last + off, kv_len - 1) / kBK;  // < first_blk: none
  const int lo_all = window < 0 ? 0 : min(q0 + (rows_used - 1) / gc, q_last) + off - window + 1;
  const int hi_all = min(q0 + off, kv_len - 1);
  const int n_blk = max(last_blk - first_blk + 1, 0);
  const int per_split = (n_blk + n_split - 1) / n_split;
  const int blk0 = first_blk + split * per_split;
  const int n_items = max(min(per_split, n_blk - split * per_split), 0);

  if (tid == 0) {
    for (int s = 0; s < WS::kStages; ++s) {
      mbar_init(full0 + 8 * s, kWGThreads);
      mbar_init(empty0 + 8 * s, 4);
      // Push: this CTA's thread 0 arrives, the peers' bytes complete the
      // phase. Pull: every warp of every panel arrives.
      mbar_init(xfull0 + 8 * s, n_pan <= WS::kPushPanels ? 1 : 4 * n_pan);
      mbar_init(xempty0 + 8 * s, 4 * n_pan);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every peer's barriers exist before the first remote arrival

  if (wgi == 1) {
    // Loader warpgroup: Q's panel once (with the first block), then each
    // block's K panel and V slab into its stage, rows in pieces of G bytes
    // by cp.async, zero past hd, past kv_len and in dead rows. Each thread
    // arrives on the stage's "full" barrier once its copies land
    // (cp.async.mbarrier.arrive), so it runs ahead to the next stage; for
    // pieces of 2 bytes (plain stores) it arrives after them.
    const int ltid = tid - kWGThreads;
    for (int it = 0; it < n_items; ++it) {
      const int st = it & 1;
      if (it >= WS::kStages) mbar_wait<false>(empty0 + 8 * st, ((it >> 1) - 1) & 1);
      const int key0 = (blk0 + it) * kBK;
      unsigned char* dst = smem + WS::stage_off + st * WS::kStage;
      with_piece<2>(row_bytes, [&](auto piece) {
        constexpr int G = decltype(piece)::value;
        constexpr int kPieces = kPanel * 2 / G;  // pieces of a panel's row
        if (it == 0) {
          for (int i = ltid; i < kRows * kPieces; i += kWGThreads) {
            const int r = i / kPieces;
            const int at = col0 + (i % kPieces) * G;
            const int pos = q0 + r / gc;
            const bool ok = r < rows_used && pos < q_len && r % gc < hc && at < row_bytes;
            const size_t g =
                ok ? ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * row_bytes + at
                   : 0;
            copy_piece<G>(smem + swz(r, (at - col0) / 16, SM::kQPanel) + (at - col0) % 16,
                          reinterpret_cast<const unsigned char*>(q) + g, ok);
          }
        }
        for (int i = ltid; i < kBK * kPieces; i += kWGThreads) {
          const int key = i / kPieces;
          const int at = col0 + (i % kPieces) * G;
          const bool ok = key0 + key < kv_len && at < row_bytes;
          const size_t g =
              ok ? ((static_cast<size_t>(b) * kv_len + key0 + key) * n_kv + h) * row_bytes + at : 0;
          unsigned char* d = dst + swz(key, (at - col0) / 16, SM::kKVPanel) + (at - col0) % 16;
          copy_piece<G>(d, reinterpret_cast<const unsigned char*>(k) + g, ok);
          copy_piece<G>(d + SM::kKV, reinterpret_cast<const unsigned char*>(v) + g, ok);
        }
      });
      if (row_piece(row_bytes) < 4) {
        mbar_arrive(full0 + 8 * st);
      } else {
        cp_async_arrive(full0 + 8 * st);
      }
    }
  } else {
    // Compute warpgroup.
    int lo[2], hi[2];  // this thread's two rows: their key range (hi = -1: dead row)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = warp * 16 + (lane >> 2) + 8 * u;
      const int pos = q0 + r / gc;
      const bool live = r < rows_used && pos < q_len && r % gc < hc;
      hi[u] = live ? min(pos + off, kv_len - 1) : -1;
      lo[u] = window < 0 ? 0 : pos + off - window + 1;
    }
    float o[2][kAcc];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[x][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
    float l[2] = {0.f, 0.f};              // this thread's share of the row sum
    float s[kS];
    float* xbuf = reinterpret_cast<float*>(smem + WS::x_off);  // [2][kS][kWGThreads]

    // No branch may skip a wgmma inside this loop: the compiler would then
    // serialize every wgmma of the kernel.
    for (int it = 0; it < n_items; ++it) {
      const int st = it & 1;
      const int k0 = (blk0 + it) * kBK;
      mbar_wait<false>(full0 + 8 * st, (it >> 1) & 1);
      fence_proxy_async();  // the loaders' writes, to wgmma's async proxy
      const uint32_t k_base = base + WS::stage_off + st * WS::kStage;

      // This panel's share of S = Q K^T, 16 columns a k-step.
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t dq = (kk >> 2) * SM::kQPanel + (kk & 3) * 32;
        const uint32_t dk = (kk >> 2) * SM::kKVPanel + (kk & 3) * 32;
        wgmma_ss(s, make_desc(base + dq, 1, 64), make_desc(k_base + dk, 1, 64), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // S is the sum of every panel's share, added in panel order in every
      // CTA of the split (this CTA's own from its registers), so all of them
      // hold the same S, m and l.
      float own[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) own[i] = s[i];
      if (n_pan <= WS::kPushPanels) {
        // Push: st.async this thread's share into each peer's slot for this
        // panel (buffer st), completing bytes on the peer's "exchange
        // full" barrier, whose own thread 0 expects the n_pan - 1 shares.
        // A peer's slot of block it - 2 is free: the peer pushed its share
        // of block it - 1, which it does only after reading block it - 2.
        float4* slots = reinterpret_cast<float4*>(smem + WS::x_off) +
                        st * (n_pan - 1) * (kS / 4) * kWGThreads;
        if (tid == 0) mbar_arrive_expect_tx(xfull0 + 8 * st, (n_pan - 1) * WS::kX);
        for (int p = 0; p < n_pan; ++p) {
          if (p == pan) continue;
          const float4* slot = slots + (pan < p ? pan : pan - 1) * (kS / 4) * kWGThreads;
#pragma unroll
          for (int q4 = 0; q4 < kS / 4; ++q4) {
            st_async16(smem_addr(slot + q4 * kWGThreads + tid), xfull0 + 8 * st, split * n_pan + p,
                       make_float4(own[4 * q4], own[4 * q4 + 1], own[4 * q4 + 2], own[4 * q4 + 3]));
          }
        }
        mbar_wait<false>(xfull0 + 8 * st, (it >> 1) & 1);
        for (int p = 0; p < n_pan; ++p) {
          const float4* slot = slots + (p < pan ? p : p - 1) * (kS / 4) * kWGThreads;
#pragma unroll
          for (int q4 = 0; q4 < kS / 4; ++q4) {
            const float4 x = p == pan ? make_float4(own[4 * q4], own[4 * q4 + 1], own[4 * q4 + 2],
                                                    own[4 * q4 + 3])
                                      : slot[q4 * kWGThreads + tid];
            s[4 * q4] = p == 0 ? x.x : s[4 * q4] + x.x;
            s[4 * q4 + 1] = p == 0 ? x.y : s[4 * q4 + 1] + x.y;
            s[4 * q4 + 2] = p == 0 ? x.z : s[4 * q4 + 2] + x.z;
            s[4 * q4 + 3] = p == 0 ? x.w : s[4 * q4 + 3] + x.w;
          }
        }
      } else {
        // Pull: this CTA's share into its own buffer st (free once every
        // panel read block it - 2), released to the cluster; then every
        // panel's read through distributed shared memory.
        float* mine = xbuf + st * kS * kWGThreads;
        if (it >= 2) mbar_wait<true>(xempty0 + 8 * st, ((it >> 1) - 1) & 1);
#pragma unroll
        for (int i = 0; i < kS; ++i) mine[i * kWGThreads + tid] = s[i];
        __syncwarp();
        if (lane == 0) {
          for (int p = 0; p < n_pan; ++p) mbar_arrive_cluster(xfull0 + 8 * st, split * n_pan + p);
        }
        mbar_wait<true>(xfull0 + 8 * st, (it >> 1) & 1);
        for (int p = 0; p < n_pan; ++p) {
          const float* xp = cluster.map_shared_rank(mine, split * n_pan + p);
#pragma unroll
          for (int i = 0; i < kS; ++i) {
            const float x = p == pan ? own[i] : xp[i * kWGThreads + tid];
            s[i] = p == 0 ? x : s[i] + x;
          }
        }
        __syncwarp();
        if (lane == 0) {
          for (int p = 0; p < n_pan; ++p) mbar_arrive_cluster(xempty0 + 8 * st, split * n_pan + p);
        }
      }

      // Blocks inside every row's keys take no mask.
      if (k0 < lo_all || k0 + kBK - 1 > hi_all) mask_block(s, k0, lane, lo, hi);
      online_softmax(s, m, l, o, scale_log2);
      uint32_t pa[kBK / 16][4];
      pack_probs(s, pa);

      // O += P V over this panel's slab, two 128-column halves.
      const uint32_t v_base = k_base + SM::kKV;
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          wgmma_rs(o[x], pa[kk],
                   make_desc(v_base + x * 2 * SM::kKVPanel + kk * 16 * 128, SM::kKVPanel / 16, 64));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // Epilogue: reduce l over the quad; one split writes its rows' slab
    // normalized, several leave their partials to the merge below.
    float* part = reinterpret_cast<float*>(smem + WS::stage_off);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      const int r = warp * 16 + (lane >> 2) + 8 * u;
      if (n_split > 1) {
        if ((lane & 3) == 0) {
          part[kRows * kPanel + r] = m[u];
          part[kRows * kPanel + kRows + r] = l[u];
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int n8 = 0; n8 < kAcc / 4; ++n8) {
            float2* dst = reinterpret_cast<float2*>(part + r * kPanel + x * 128 + 8 * n8 +
                                                    2 * (lane & 3));
            *dst = make_float2(o[x][4 * n8 + 2 * u], o[x][4 * n8 + 2 * u + 1]);
          }
        continue;
      }
      const int pos = q0 + r / gc;
      if (r >= rows_used || pos >= q_len || r % gc >= hc) continue;
      const float inv = l[u] == 0.f ? 0.f : 1.f / l[u];  // no valid key: O is 0
      store_row(out + ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * hd, o, u,
                inv, hd, pan * kPanel, lane);
    }
  }

  if (n_split > 1) {
    // Merge the splits: rank (pan, split) writes rows [r0, r1) of its
    // panel's slab from every split's partial, in split order.
    cluster.sync();
    const float* mine = reinterpret_cast<const float*>(smem + WS::stage_off);
    const int r0 = split * kRows / n_split;
    const int r1 = (split + 1) * kRows / n_split;
    for (int i = tid; i < (r1 - r0) * kPanel; i += 2 * kWGThreads) {
      const int r = r0 + i / kPanel;
      const int c = i % kPanel;
      const int pos = q0 + r / gc;
      if (r >= rows_used || pos >= q_len || r % gc >= hc || pan * kPanel + c >= hd) continue;
      float mm = -INFINITY;
      for (int sp = 0; sp < n_split; ++sp) {
        mm = fmaxf(mm, cluster.map_shared_rank(mine, sp * n_pan + pan)[kRows * kPanel + r]);
      }
      float ll = 0.f, a = 0.f;
      if (mm != -INFINITY) {
        for (int sp = 0; sp < n_split; ++sp) {
          const float* ps = cluster.map_shared_rank(mine, sp * n_pan + pan);
          const float ms = ps[kRows * kPanel + r];
          if (ms == -INFINITY) continue;  // a split with no live key for this row
          const float f = exp2f(ms - mm);
          ll = fmaf(f, ps[kRows * kPanel + kRows + r], ll);
          a = fmaf(f, ps[r * kPanel + c], a);
        }
      }
      out[((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * hd + pan * kPanel +
          c] = __float2bfloat16(ll == 0.f ? 0.f : a / ll);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
}

// Head dims above kMaxCluster panels (2,048): one warpgroup (64 rows) a CTA,
// its slab of kPanel columns of O, grid x (kv head, head chunk, slab). A
// ring stage holds Q's panel (laid out as the HD-256 Q tile), then K's
// panel of a 64-key block or V's slab of it (as the HD-256 K/V tile).
constexpr int kMaxCluster = 8;  // the portable cluster: panels of one cluster kernel
struct PanelSmem {
  using Tile = Smem<kPanel, 1>;
  static constexpr int kStage = Tile::kQ + Tile::kKV;
  static constexpr int bytes = kStages * kStage + 1024;  // + alignment slack
};

// The HD-256 one-warpgroup kernel walking every panel for its slab
// (blockIdx.x % n_panels(hd)) of the output: per 64-key block, one stage
// per panel p adds Q_p K_p^T to S, then one stage of V's slab runs the mask,
// the online softmax and O += P V. Q is read again from L2 each block and K
// once a slab, so S is computed n_panels times; it serves the head dims that
// the cluster kernel's panels do not fit.
__global__ void __launch_bounds__(kWGThreads) flash_prefill_panel_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ offsets, int offset, bf16* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int gc, int hd, int window, float scale_log2) {
  using SM = PanelSmem::Tile;
  constexpr int kBK = SM::kBK;     // 64 keys a block
  constexpr int kAcc = kPanel / 4;  // O floats of one m64n128 product
  constexpr int kS = kBK / 2;      // S accumulator floats per thread

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_pan = n_panels(hd);
  const int slab = blockIdx.x % n_pan;
  const int n_gc = (group + gc - 1) / gc;
  const int h = blockIdx.x / n_pan / n_gc;
  const int head0 = h * group + (blockIdx.x / n_pan % n_gc) * gc;
  const int hc = min(gc, (h + 1) * group - head0);
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // heaviest q-blocks first
  const int block_q = kRows / gc;             // query positions per CTA
  const int rows_used = block_q * gc;
  const int q0 = qb * block_q;
  const int off = offsets != nullptr ? offsets[b] : offset;
  const int row_bytes = hd * 2;

  // k-blocks some row attends, and the keys every row attends.
  const int q_last = min(q0 + block_q, q_len) - 1;
  const int first_blk = (window < 0 ? 0 : max(q0 + off - window + 1, 0)) / kBK;
  const int last_blk = min(q_last + off, kv_len - 1) / kBK;  // < first_blk: none
  const int lo_all = window < 0 ? 0 : min(q0 + (rows_used - 1) / gc, q_last) + off - window + 1;
  const int hi_all = min(q0 + off, kv_len - 1);

  int lo[2], hi[2];  // this thread's two rows: their key range (hi = -1: dead row)
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = warp * 16 + (lane >> 2) + 8 * u;
    const int pos = q0 + r / gc;
    const bool live = r < rows_used && pos < q_len && r % gc < hc;
    hi[u] = live ? min(pos + off, kv_len - 1) : -1;
    lo[u] = window < 0 ? 0 : pos + off - window + 1;
  }

  // Stage `it`: block first_blk + it / (n_pan + 1); at p = it % (n_pan + 1)
  // < n_pan Q's and K's panel p, at n_pan V's slab. Rows in pieces of G
  // bytes, zero past hd, past kv_len and in dead rows.
  const int per_blk = n_pan + 1;
  const int n_items = last_blk >= first_blk ? (last_blk - first_blk + 1) * per_blk : 0;
  auto load_item = [&](int it) {
    const int key0 = (first_blk + it / per_blk) * kBK;
    const int p = it % per_blk;
    const int col0 = (p < n_pan ? p : slab) * kPanel * 2;  // the panel's first byte in a row
    unsigned char* st = smem + (it % kStages) * PanelSmem::kStage;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(p < n_pan ? k : v);
    with_piece<2>(row_bytes, [&](auto piece) {
      constexpr int G = decltype(piece)::value;
      constexpr int kPieces = kPanel * 2 / G;  // pieces of a panel's row
      if (p < n_pan) {
        for (int i = tid; i < kRows * kPieces; i += kWGThreads) {
          const int r = i / kPieces;
          const int at = col0 + (i % kPieces) * G;
          const int pos = q0 + r / gc;
          const bool ok = r < rows_used && pos < q_len && r % gc < hc && at < row_bytes;
          const size_t g =
              ok ? ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * row_bytes + at
                 : 0;
          copy_piece<G>(st + swz(r, (at - col0) / 16, SM::kQPanel) + (at - col0) % 16,
                        reinterpret_cast<const unsigned char*>(q) + g, ok);
        }
      }
      for (int i = tid; i < kBK * kPieces; i += kWGThreads) {
        const int key = i / kPieces;
        const int at = col0 + (i % kPieces) * G;
        const bool ok = key0 + key < kv_len && at < row_bytes;
        const size_t g =
            ok ? ((static_cast<size_t>(b) * kv_len + key0 + key) * n_kv + h) * row_bytes + at : 0;
        copy_piece<G>(st + SM::kQ + swz(key, (at - col0) / 16, SM::kKVPanel) + (at - col0) % 16,
                      src + g, ok);
      }
    });
  };
  if (n_items > 0) load_item(0);
  cp_async_commit();

  float o[2][kAcc];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[x][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float s[kS];

  // Waits for stage `it` (every thread's copies, visible to wgmma), then
  // starts the next one into the stage the previous one freed.
  auto next_stage = [&](int it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_items) load_item(it + 1);
    cp_async_commit();
    return base + (it % kStages) * PanelSmem::kStage;
  };
  int it = 0;
  for (int j = first_blk; j <= last_blk; ++j) {
    const int first_key = j * kBK;
    // S = Q K^T, a panel of the head dim a stage, 16 columns a k-step.
    for (int p = 0; p < n_pan; ++p, ++it) {
      const uint32_t q_base = next_stage(it);
      const uint32_t k_base = q_base + SM::kQ;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        const uint32_t dq = (kk >> 2) * SM::kQPanel + (kk & 3) * 32;
        const uint32_t dk = (kk >> 2) * SM::kKVPanel + (kk & 3) * 32;
        wgmma_ss(s, make_desc(q_base + dq, 1, 64), make_desc(k_base + dk, 1, 64), p | kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
    const uint32_t v_base = next_stage(it) + SM::kQ;
    ++it;

    if (first_key < lo_all || first_key + kBK - 1 > hi_all) {
      mask_block(s, first_key, lane, lo, hi);
    }
    online_softmax(s, m, l, o, scale_log2);
    uint32_t pa[kBK / 16][4];
    pack_probs(s, pa);

    // O += P V over the slab's two 128-column halves.
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        wgmma_rs(o[x], pa[kk],
                 make_desc(v_base + x * 2 * SM::kKVPanel + kk * 16 * 128, SM::kKVPanel / 16, 64));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // Epilogue: reduce l over the quad, normalize, store the slab's columns.
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const int r = warp * 16 + (lane >> 2) + 8 * u;
    const int pos = q0 + r / gc;
    if (r >= rows_used || pos >= q_len || r % gc >= hc) continue;
    const float inv = l[u] == 0.f ? 0.f : 1.f / l[u];  // no valid key: O is 0
    store_row(out + ((static_cast<size_t>(b) * q_len + pos) * n_q + head0 + r % gc) * hd, o, u,
              inv, hd, slab * kPanel, lane);
  }
}

cudaError_t launch_panels(const void* q, const void* k, const void* v, const void* offsets,
                          int offset, void* out, int batch, int q_len, int kv_len, int n_q,
                          int n_kv, int hd, int window, float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int gc = head_chunk(group, kRows);
  const int block_q = kRows / gc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PanelSmem::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_kv * ((group + gc - 1) / gc) * n_panels(hd), batch,
                  (q_len + block_q - 1) / block_q);
  flash_prefill_panel_kernel<<<grid, kWGThreads, PanelSmem::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(offsets), offset, static_cast<bf16*>(out), q_len, kv_len, n_q, n_kv,
      group, gc, hd, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// key_splits: the key splits a query tile's cluster takes (ops/flash_prefill.py
// `wide_plan`); the cluster, n_panels(hd) x key_splits CTAs, is at most the
// portable 8. More panels than that run flash_prefill_panel_kernel
// (key_splits 1).
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* offsets,
                        int offset, void* out, int batch, int q_len, int kv_len, int n_q, int n_kv,
                        int hd, int window, int key_splits, float scale, cudaStream_t stream) {
  if (n_panels(hd) > kMaxCluster) {
    if (key_splits != 1) return cudaErrorInvalidValue;
    return launch_panels(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, hd,
                         window, scale, stream);
  }
  const int group = n_q / n_kv;
  const int gc = head_chunk(group, kRows);
  const int block_q = kRows / gc;
  const int csize = n_panels(hd) * key_splits;
  if (key_splits < 1 || csize > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WideSmem::bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_kv * ((group + gc - 1) / gc) * csize, batch, (q_len + block_q - 1) / block_q);
  cfg.blockDim = dim3(2 * kWGThreads);
  cfg.dynamicSmemBytes = WideSmem::bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_prefill_wide_kernel, static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                           static_cast<const int*>(offsets), offset, static_cast<bf16*>(out),
                           q_len, kv_len, n_q, n_kv, group, gc, hd, window,
                           scale * 1.4426950408889634f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: register-tiled CUDA-core FMAs, the softmax on registers, K/V on a
// cp.async ring (the design note at the top of this file).

namespace f32 {

constexpr int kRows = 64;  // tile rows per CTA (positions x group heads)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The CTA's share of the grid. Grid x is (kv head, chunk of gc query heads,
// slab), y the batch row, z the q-block, heaviest (most keys) first. Row r
// (0 .. kRows - 1) of the tile is query position q0 + r / gc of query head
// head0 + r % gc. Above head_dim 256 the CTA writes O's slab `slab` of
// kPanel columns, and S sums over n_pan panels.
struct Cta {
  int n_pan, slab, h, head0, hc, b, gc, rows_used, q0, q_last, off;
  __device__ Cta(const int* offsets, int offset, int q_len, int group, int gc_, int hd, bool panels)
      : n_pan(panels ? n_panels(hd) : 1), gc(gc_) {
    slab = blockIdx.x % n_pan;
    const int n_gc = (group + gc - 1) / gc;
    h = blockIdx.x / n_pan / n_gc;
    head0 = h * group + (blockIdx.x / n_pan % n_gc) * gc;
    hc = min(gc, (h + 1) * group - head0);
    b = blockIdx.y;
    const int block_q = kRows / gc;  // query positions per CTA
    rows_used = block_q * gc;
    q0 = (gridDim.z - 1 - blockIdx.z) * block_q;
    q_last = min(q0 + block_q, q_len) - 1;
    off = offsets != nullptr ? offsets[b] : offset;
  }
  __device__ bool live(int r) const {
    return r < rows_used && q0 + r / gc <= q_last && r % gc < hc;
  }
  __device__ size_t q_row(int r, int q_len, int n_q) const {
    return (static_cast<size_t>(b) * q_len + q0 + r / gc) * n_q + head0 + r % gc;
  }
  // Key blocks of kBN keys some row attends: the first, and how many (<= 0: none).
  __device__ int first_block(int window, int kBN) const {
    return (window < 0 ? 0 : max(q0 + off - window + 1, 0)) / kBN;
  }
  __device__ int n_blocks(int window, int kv_len, int kBN) const {
    return min(q_last + off, kv_len - 1) / kBN - first_block(window, kBN) + 1;
  }
  // Rows r0 .. r0 + n - 1: the keys every live one of them attends, [lo, hi].
  __device__ void common_keys(int r0, int n, int window, int kv_len, int& lo, int& hi) const {
    const int p0 = q0 + r0 / gc;
    const int p1 = min(q0 + (min(r0 + n, rows_used) - 1) / gc, q_last);
    hi = min(p0 + off, kv_len - 1);
    lo = window < 0 ? 0 : p1 + off - window + 1;
  }
  // Row r's key range [lo, hi] (hi = -1: a dead row).
  __device__ void keys(int r, int window, int kv_len, int& lo, int& hi) const {
    const int pos = q0 + r / gc;
    hi = live(r) ? min(pos + off, kv_len - 1) : -1;
    lo = window < 0 ? 0 : pos + off - window + 1;
  }
};

// Panel p of `rows` rows of src (row r at row_of(r) * hd elements) into
// dst, rows kLD floats apart, in pieces of G bytes (16 at hd == HD); a piece
// past hd or a row that live(r) refuses is zero-filled. Not committed.
template <int HD, int kLD, typename RowOf, typename Live>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows, int p,
                                          int row_bytes, RowOf row_of, Live live) {
  with_piece<4>(row_bytes, [&](auto piece) {
    constexpr int G = decltype(piece)::value;
    constexpr int kPieces = HD * 4 / G;  // pieces of a padded row
    for (int i = threadIdx.x; i < rows * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int byte = p * HD * 4 + (i % kPieces) * G;
      const bool ok = live(r) && byte < row_bytes;
      const unsigned char* g = reinterpret_cast<const unsigned char*>(src) +
                               (ok ? row_of(r) * static_cast<size_t>(row_bytes) + byte : 0);
      copy_piece<G>(reinterpret_cast<unsigned char*>(dst + r * kLD) + (i % kPieces) * G, g, ok);
    }
  });
}

// s[i][j] += Q row (qr + i kSA rows) . K row (kr + j kSB rows) over HD
// columns, rows kLD floats apart: per 4 columns, 4 + kKS float4 loads feed
// 16 kKS FMAs.
template <int HD, int kLD, int kSA, int kSB, int kKS>
__device__ __forceinline__ void scores(float (&s)[4][kKS], const float* qr, const float* kr) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], kv[kKS];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qr + kSA * i * kLD + d);
#pragma unroll
    for (int j = 0; j < kKS; ++j) kv[j] = *reinterpret_cast<const float4*>(kr + kSB * j * kLD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }
}

// Keys kw0 + sb + kSB j outside a row's [lo, hi] get -inf.
template <int kSB, int kKS>
__device__ __forceinline__ void mask_keys(float (&s)[4][kKS], int kw0, int sb, const int (&lo)[4],
                                          const int (&hi)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kKS; ++j) {
      const int kp = kw0 + sb + kSB * j;
      if (kp > hi[i] || kp < lo[i]) s[i][j] = -INFINITY;
    }
}

// Online softmax in the exp2 domain over a lane's 4 rows, each spread over
// kSB lanes (shuffles within them): s (raw scores, -inf where masked)
// becomes P, m (running max, log2 domain) and l (this lane's share of the
// row sum) update, and P goes to the warp's P rows (pr: row 0 of the lane's
// first, rows kSA apart; key column j at kSB j) and each row's rescale to
// `alpha_rows` (lanes with key lane 0).
template <int kSA, int kSB, int kKS, int kLP>
__device__ __forceinline__ void softmax(float (&s)[4][kKS], float (&m)[4], float (&l)[4],
                                        float scale_log2, float* pr, float* alpha_rows,
                                        bool key_lane0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < kKS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int x = 1; x < kSB; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    // A row still fully masked keeps m == -inf: pin the rescale to 0
    // (-inf - -inf is NaN) and shift by 0 instead of m_new.
    const float alpha = m_new == -INFINITY ? 0.f : ex2(m[i] - m_new);
    const float shift = m_new == -INFINITY ? 0.f : m_new;
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKS; ++j) {
      const float p = ex2(fmaf(s[i][j], scale_log2, -shift));
      pr[kSA * i * kLP + kSB * j] = p;
      sum += p;
    }
    l[i] = fmaf(alpha, l[i], sum);
    if (key_lane0) alpha_rows[kSA * i] = alpha;
  }
}

// O (8 rows, kOA rows apart; kC4 float4 columns, 4 kOB apart) *= its rows'
// alpha, then += P V over kKW keys: per 4 keys, 8 float4 loads of P and
// 4 kC4 of V feed 128 kC4 FMAs.
template <int kKW, int kLD, int kLP, int kOA, int kOB, int kC4>
__device__ __forceinline__ void accumulate(float (&o)[8][4 * kC4], const float* alpha_rows,
                                           const float* pr, const float* vr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = alpha_rows[kOA * i];
#pragma unroll
    for (int c = 0; c < 4 * kC4; ++c) o[i][c] *= a;
  }
#pragma unroll 2
  for (int t = 0; t < kKW; t += 4) {
    float4 p4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p4[i] = *reinterpret_cast<const float4*>(pr + kOA * i * kLP + t);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int c = 0; c < kC4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + (t + tt) * kLD + 4 * kOB * c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = tt == 0 ? p4[i].x : tt == 1 ? p4[i].y : tt == 2 ? p4[i].z : p4[i].w;
          o[i][4 * c] = fmaf(p, vv.x, o[i][4 * c]);
          o[i][4 * c + 1] = fmaf(p, vv.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(p, vv.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(p, vv.w, o[i][4 * c + 3]);
        }
      }
    }
  }
}

// After the last block: each warp leaves its rows' m and row sum (reduced
// over the kSB key lanes) in ml[0 .. 2 kRows) and its unnormalized O in
// mo (rows kLD apart), one buffer per half of the keys; then, after a
// barrier, the halves merge in a fixed order and the live rows' columns
// below hd go out, 4 at a time where rows are 16-byte aligned (a row with
// no valid key writes zeros).
template <int HD, int kLD, int kHalves>
__device__ __forceinline__ void merge_store(const Cta& c, const float* mo, const float* ml,
                                            float* out, int hd, int q_len, int n_q) {
  for (int e = threadIdx.x; e < kRows * (HD / 4); e += kThreads) {
    const int r = e / (HD / 4);
    const int c0 = 4 * (e % (HD / 4));
    const int gcol = c.slab * HD + c0;  // the output column of c0
    if (!c.live(r) || gcol >= hd) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int x = 0; x < kHalves; ++x) mx = fmaxf(mx, ml[x * 2 * kRows + r]);
    float sum = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int x = 0; x < kHalves; ++x) {
      const float mh = ml[x * 2 * kRows + r];
      const float w = mh == -INFINITY ? 0.f : exp2f(mh - mx);  // a half with no live key: 0
      sum = fmaf(w, ml[x * 2 * kRows + kRows + r], sum);
      const float4 oh = *reinterpret_cast<const float4*>(mo + (x * kRows + r) * kLD + c0);
      acc[0] = fmaf(w, oh.x, acc[0]);
      acc[1] = fmaf(w, oh.y, acc[1]);
      acc[2] = fmaf(w, oh.z, acc[2]);
      acc[3] = fmaf(w, oh.w, acc[3]);
    }
    const float inv = sum == 0.f ? 0.f : 1.f / sum;
    float* dst = out + c.q_row(r, q_len, n_q) * hd + gcol;
    if (hd % 4 == 0 && gcol + 3 < hd) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (gcol + x < hd) dst[x] = acc[x] * inv;
      }
    }
  }
}

// Leave a warp's m, row sums and O for merge_store (see there).
template <int kLD, int kSA, int kSB, int kOA, int kOB, int kC4>
__device__ __forceinline__ void stage_partials(float* mo, float* ml, const float (&o)[8][4 * kC4],
                                               const float (&m)[4], float (&l)[4], int s_row0,
                                               bool key_lane0, int o_row0, int o_col0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x < kSB; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    if (key_lane0) {
      ml[s_row0 + kSA * i] = m[i];
      ml[kRows + s_row0 + kSA * i] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kC4; ++c) {
      *reinterpret_cast<float4*>(mo + (o_row0 + kOA * i) * kLD + o_col0 + 4 * kOB * c) =
          make_float4(o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2], o[i][4 * c + 3]);
    }
}

// Up to head_dim 256 (HD 64, 128, 256; hd <= HD). A warp owns kWarpRows
// rows of the tile and takes kKW = 64 keys of every key block: up to 128 the
// blocks are 128 keys and two warps share a row group of 16 rows, one for
// each half of every block (each keeps its own m, l and O over its keys;
// the halves merge once, after the last block); at 256 the blocks are 64
// keys and a warp owns 8 rows (O stays at 64 registers a lane). S and O
// take different lane grids, so that each float a lane loads feeds as many
// FMAs as the registers allow: of S a lane holds 4 rows (lane / kSB + kSA
// i) by kKS keys (lane % kSB + kSB j), of O 8 rows (lane / kOB + kOA i) by
// kC4 float4 columns (4 (lane % kOB) + 4 kOB c). Q, K and V rows are padded
// to kLD = HD + 4 floats (rows 1 apart are 4 banks apart) and P's to kLP
// (32 / kSA banks apart), so every warp access of a phase takes the fewest
// wavefronts its bytes allow.
template <int HD>
struct Plan {
  static constexpr int kBN = HD > 128 ? 64 : 128;   // keys per block
  static constexpr int kHalves = HD > 128 ? 1 : 2;  // warps sharing a row group
  static constexpr int kWarpRows = kRows * kHalves / kWarps;
  static constexpr int kKW = kBN / kHalves;
  static constexpr int kSA = kWarpRows / 4;
  static constexpr int kSB = 32 / kSA;
  static constexpr int kKS = kKW / kSB;
  static constexpr int kOA = kWarpRows / 8;
  static constexpr int kOB = 32 / kOA;
  static constexpr int kC4 = HD / (4 * kOB);
  static constexpr int kLD = HD + 4;
  static constexpr int kLP = kKW + 32 / kSA;
  // Q, one block's K and V (each requested during the other's phase), each
  // warp's P rows and their rescales. After the last block K's tile holds
  // the halves' O and Q's their m and l.
  static constexpr int k_off = kRows * kLD;
  static constexpr int v_off = k_off + kBN * kLD;
  static constexpr int p_off = v_off + kBN * kLD;
  static constexpr int a_off = p_off + kWarps * kWarpRows * kLP;
  static constexpr size_t bytes = sizeof(float) * (a_off + kWarps * kWarpRows);
  static_assert(kHalves * kRows <= kBN && kKW == 64 && kC4 >= 1, "the plan's tiles");
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ offsets, int offset, float* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int gc, int hd, int window, float scale_log2) {
  using PL = Plan<HD>;
  constexpr int kBN = PL::kBN, kKW = PL::kKW, kLD = PL::kLD, kLP = PL::kLP;
  constexpr int kSA = PL::kSA, kSB = PL::kSB, kKS = PL::kKS;
  constexpr int kOA = PL::kOA, kOB = PL::kOB, kC4 = PL::kC4;
  constexpr int kWarpRows = PL::kWarpRows;

  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;
  float* const ks = smem + PL::k_off;
  float* const vs = smem + PL::v_off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = warp / (kWarps / PL::kHalves);               // this warp's half of a block
  const int r0 = warp % (kWarps / PL::kHalves) * kWarpRows;  // its row group's first row
  const int sa = lane / kSB, sb = lane % kSB;                // S: rows r0 + sa + kSA i
  const int oa = lane / kOB, ob = lane % kOB;                // O: rows r0 + oa + kOA i
  float* const pw = smem + PL::p_off + warp * kWarpRows * kLP;  // this warp's P rows
  float* const aw = smem + PL::a_off + warp * kWarpRows;        // and their rescales

  const Cta c(offsets, offset, q_len, group, gc, hd, false);
  const int row_bytes = hd * 4;
  const int first_blk = c.first_block(window, kBN);
  const int n_blocks = c.n_blocks(window, kv_len, kBN);
  int lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c.keys(r0 + sa + kSA * i, window, kv_len, lo[i], hi[i]);
  int lo_all, hi_all;  // keys of a block inside both take no mask
  c.common_keys(r0, kWarpRows, window, kv_len, lo_all, hi_all);

  // K or V of the block at key0. At hd == HD thread tid copies the 16-byte
  // chunk tid % kChunks of rows tid / kChunks + kPass i: one pointer step a
  // copy; else rows go in pieces (copy_rows).
  constexpr int kChunks = HD / 4;
  constexpr int kPass = kThreads / kChunks;
  const size_t key_stride = static_cast<size_t>(n_kv) * hd;  // floats from key to key
  const size_t g_thread = (static_cast<size_t>(c.b) * kv_len + tid / kChunks) * key_stride +
                          static_cast<size_t>(c.h) * hd + tid % kChunks * 4;
  const int s_thread = tid / kChunks * kLD + tid % kChunks * 4;
  auto load_tile = [&](float* dst, const float* src, int key0) {
    if (hd != HD) {
      copy_rows<HD, kLD>(
          dst, src, kBN, 0, row_bytes,
          [&](int r) { return (static_cast<size_t>(c.b) * kv_len + key0 + r) * n_kv + c.h; },
          [&](int r) { return key0 + r < kv_len; });
    } else {
      const float* g = src + g_thread + key0 * key_stride;
      const bool full = key0 + kBN <= kv_len;
#pragma unroll
      for (int i = 0; i < kBN / kPass; ++i) {
        const bool ok = full || key0 + tid / kChunks + i * kPass < kv_len;
        cp_async16_zfill(dst + s_thread + i * kPass * kLD, ok ? g + i * kPass * key_stride : src,
                         ok);
      }
    }
    cp_async_commit();
  };

  copy_rows<HD, kLD>(
      qs, q, kRows, 0, row_bytes, [&](int r) { return c.q_row(r, q_len, n_q); },
      [&](int r) { return c.live(r); });
  cp_async_commit();
  if (n_blocks > 0) load_tile(ks, k, first_blk * kBN);

  float o[8][4 * kC4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int x = 0; x < 4 * kC4; ++x) o[i][x] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_blocks; ++it) {
    const int k0 = (first_blk + it) * kBN;
    const int kw0 = k0 + kh * kKW;  // this warp's first key of the block
    // K has landed and every warp is done with the last block's V: request
    // this block's V, to land while S runs.
    cp_async_wait<0>();
    __syncthreads();
    load_tile(vs, v, k0);

    float s[4][kKS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKS; ++j) s[i][j] = 0.f;
    scores<HD, kLD, kSA, kSB, kKS>(s, qs + (r0 + sa) * kLD, ks + (kh * kKW + sb) * kLD);
    // Only keys that cross one of the row group's limits are masked.
    if (kw0 + kKW - 1 > hi_all || kw0 < lo_all) mask_keys<kSB, kKS>(s, kw0, sb, lo, hi);
    softmax<kSA, kSB, kKS, kLP>(s, m, l, scale_log2, pw + sa * kLP + sb, aw + sa, sb == 0);

    // V has landed and every warp is done with K: request the next block's
    // K, to land while P V runs.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_blocks) load_tile(ks, k, k0 + kBN);
    accumulate<kKW, kLD, kLP, kOA, kOB, kC4>(o, aw + oa, pw + oa * kLP,
                                             vs + kh * kKW * kLD + 4 * ob);
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are free for the merge
  stage_partials<kLD, kSA, kSB, kOA, kOB, kC4>(ks + kh * kRows * kLD, qs + kh * 2 * kRows, o, m,
                                               l, r0 + sa, sb == 0, r0 + oa, 4 * ob);
  __syncthreads();
  merge_store<HD, kLD, PL::kHalves>(c, ks, qs, out, hd, q_len, n_q);
}

// Above head_dim 256: a CTA a slab of kPanel columns of O, S over every
// panel of the head dim (computed once a slab). The K/V tiles of 32 keys
// stream through a ring of two slots, n_pan K panels and V's slab a block,
// tile u requested at tile u - 1's barrier; Q's two panels stay resident
// at n_pan == 2, else each K panel brings Q's panel along (Q buffer c % 2
// for the c-th K panel). A warp owns 8 rows, S and O on the lane grids of
// the HD-256 plan (4 rows by 2 keys of S, 8 rows by 8 columns of O).
struct PanelPlan {
  static constexpr int kBN = 32;
  static constexpr int kWarpRows = kRows / kWarps;
  static constexpr int kSA = 2, kSB = 16, kKS = kBN / kSB;
  static constexpr int kOA = 1, kOB = 32, kC4 = kPanel / (4 * kOB);
  static constexpr int kLD = kPanel + 4;
  static constexpr int kLP = kBN + 32 / kSA;
  static constexpr int kQ = kRows * kLD;   // a Q panel
  static constexpr int kTile = kBN * kLD;  // a K panel or V slab
  // Q's two panels, two tiles, each warp's P rows and rescales. After the
  // last block Q's first panel holds O and the second m and l.
  static constexpr int slot_off = 2 * kQ;
  static constexpr int p_off = slot_off + 2 * kTile;
  static constexpr int a_off = p_off + kWarps * kWarpRows * kLP;
  static constexpr size_t bytes = sizeof(float) * (a_off + kWarps * kWarpRows);
};

__global__ void __launch_bounds__(kThreads, 1) flash_prefill_f32_panel_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ offsets, int offset, float* __restrict__ out, int q_len, int kv_len,
    int n_q, int n_kv, int group, int gc, int hd, int window, float scale_log2) {
  using PL = PanelPlan;
  constexpr int kBN = PL::kBN, kLD = PL::kLD, kLP = PL::kLP, kTile = PL::kTile;
  constexpr int kSA = PL::kSA, kSB = PL::kSB, kKS = PL::kKS;
  constexpr int kOA = PL::kOA, kOB = PL::kOB, kC4 = PL::kC4;
  constexpr int kWarpRows = PL::kWarpRows;

  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kWarpRows;
  const int sa = lane / kSB, sb = lane % kSB;
  const int oa = lane / kOB, ob = lane % kOB;
  float* const pw = smem + PL::p_off + warp * kWarpRows * kLP;
  float* const aw = smem + PL::a_off + warp * kWarpRows;
  auto q_tile = [&](int i) { return smem + i * PL::kQ; };
  auto slot = [&](int u) { return smem + PL::slot_off + (u % 2) * kTile; };

  const Cta c(offsets, offset, q_len, group, gc, hd, true);
  const int n_pan = c.n_pan;
  const bool q_resident = n_pan == 2;
  const int row_bytes = hd * 4;
  const int first_blk = c.first_block(window, kBN);
  const int n_blocks = c.n_blocks(window, kv_len, kBN);
  int lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c.keys(r0 + sa + kSA * i, window, kv_len, lo[i], hi[i]);
  int lo_all, hi_all;
  c.common_keys(r0, kWarpRows, window, kv_len, lo_all, hi_all);

  auto load_q = [&](float* dst, int p) {
    copy_rows<kPanel, kLD>(
        dst, q, kRows, p, row_bytes, [&](int r) { return c.q_row(r, q_len, n_q); },
        [&](int r) { return c.live(r); });
  };
  // Tile u: block u / (n_pan + 1), part u % (n_pan + 1) (K's panels, then
  // V's slab), with Q's panel where Q streams. One cp.async group a tile.
  auto issue = [&](int u) {
    const int it = u / (n_pan + 1);
    const int p = u % (n_pan + 1);
    if (it < n_blocks) {
      const int key0 = (first_blk + it) * kBN;
      copy_rows<kPanel, kLD>(
          slot(u), p < n_pan ? k : v, kBN, p < n_pan ? p : c.slab, row_bytes,
          [&](int r) { return (static_cast<size_t>(c.b) * kv_len + key0 + r) * n_kv + c.h; },
          [&](int r) { return key0 + r < kv_len; });
      if (p < n_pan && !q_resident) load_q(q_tile((it * n_pan + p) % 2), p);
    }
    cp_async_commit();
  };
  // Tile u has landed for every thread and every thread is done with tile
  // u - 1: request tile u + 1 into its slot.
  auto handoff = [&](int u) {
    cp_async_wait<0>();
    __syncthreads();
    issue(u + 1);
  };

  if (q_resident) {  // Q rides in the first group
    load_q(q_tile(0), 0);
    load_q(q_tile(1), 1);
  }
  issue(0);

  float o[8][4 * kC4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int x = 0; x < 4 * kC4; ++x) o[i][x] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_blocks; ++it) {
    const int k0 = (first_blk + it) * kBN;
    const int u0 = it * (n_pan + 1);
    float s[4][kKS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKS; ++j) s[i][j] = 0.f;
    for (int p = 0; p < n_pan; ++p) {
      handoff(u0 + p);
      scores<kPanel, kLD, kSA, kSB, kKS>(
          s, q_tile(q_resident ? p : (it * n_pan + p) % 2) + (r0 + sa) * kLD,
          slot(u0 + p) + sb * kLD);
    }
    handoff(u0 + n_pan);
    if (k0 + kBN - 1 > hi_all || k0 < lo_all) mask_keys<kSB, kKS>(s, k0, sb, lo, hi);
    softmax<kSA, kSB, kKS, kLP>(s, m, l, scale_log2, pw + sa * kLP + sb, aw + sa, sb == 0);
    __syncwarp();  // P and the rescales of the warp's rows are in shared memory
    accumulate<kBN, kLD, kLP, kOA, kOB, kC4>(o, aw + oa, pw + oa * kLP, slot(u0 + n_pan) + 4 * ob);
  }
  cp_async_wait<0>();
  __syncthreads();  // Q's panels are free for the merge
  stage_partials<kLD, kSA, kSB, kOA, kOB, kC4>(q_tile(0), q_tile(1), o, m, l, r0 + sa, sb == 0,
                                               r0 + oa, 4 * ob);
  __syncthreads();
  merge_store<kPanel, kLD, 1>(c, q_tile(0), q_tile(1), out, hd, q_len, n_q);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int n_pan, const void* q, const void* k,
                          const void* v, const void* offsets, int offset, void* out, int batch,
                          int q_len, int kv_len, int n_q, int n_kv, int hd, int window,
                          float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int gc = head_chunk(group, kRows);
  const int block_q = kRows / gc;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_kv * ((group + gc - 1) / gc) * n_pan, batch, (q_len + block_q - 1) / block_q);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(offsets), offset, static_cast<float*>(out), q_len, kv_len, n_q,
      n_kv, group, gc, hd, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// HD: the padded width up to 256; above it (HD 256) the panel kernel.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offsets, int offset,
                   void* out, int batch, int q_len, int kv_len, int n_q, int n_kv, int hd,
                   int window, float scale, cudaStream_t stream) {
  if (hd > kPanel) {
    return launch_kernel(flash_prefill_f32_panel_kernel, PanelPlan::bytes, n_panels(hd), q, k, v,
                         offsets, offset, out, batch, q_len, kv_len, n_q, n_kv, hd, window, scale,
                         stream);
  }
  return launch_kernel(flash_prefill_f32_kernel<HD>, Plan<HD>::bytes, 1, q, k, v, offsets, offset,
                       out, batch, q_len, kv_len, n_q, n_kv, hd, window, scale, stream);
}

}  // namespace f32

}  // namespace

// q [batch, q_len, n_q, head_dim]; k/v [batch, kv_len, n_kv, head_dim];
// offsets [batch] int32 causal offsets on the device, or null for one
// `offset` shared by every batch row; out like q. window < 0: no sliding
// window. dtype 0 = f32, 1 = bf16, at any head_dim >= 1; any n_q / n_kv
// (the GQA group). key_splits: the key splits of a query tile in bf16 from
// head_dim 257 to 2,048 (n_panels(head_dim) x key_splits at most 8), else
// 1.
// Returns the launch's cudaError_t.
extern "C" int kvt_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* offsets, int offset, void* out, int batch,
                                 int q_len, int kv_len, int n_q, int n_kv, int head_dim,
                                 int window, int key_splits, float scale, int dtype,
                                 void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv < 1 || batch <= 0 || q_len <= 0 ||
      kv_len <= 0 || padded(head_dim) == 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto hd_padded) {
    constexpr int HD = decltype(hd_padded)::value;
    return dtype == 1 ? wg::launch<HD>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q,
                                       n_kv, head_dim, window, scale, s)
                      : f32::launch<HD>(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q,
                                        n_kv, head_dim, window, scale, s);
  };
  cudaError_t err;
  switch (padded(head_dim)) {
    case 64: err = go(std::integral_constant<int, 64>{}); break;
    case 128: err = go(std::integral_constant<int, 128>{}); break;
    case 256: err = go(std::integral_constant<int, 256>{}); break;
    default:  // above 256: slabs and panels of 256
      err = dtype == 1 ? wg::launch_wide(q, k, v, offsets, offset, out, batch, q_len, kv_len, n_q,
                                         n_kv, head_dim, window, key_splits, scale, s)
                       : f32::launch<256>(q, k, v, offsets, offset, out, batch, q_len, kv_len,
                                          n_q, n_kv, head_dim, window, scale, s);
      break;
  }
  return static_cast<int>(err);
}
