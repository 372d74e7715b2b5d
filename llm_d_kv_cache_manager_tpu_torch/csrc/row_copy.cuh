// The head-dim padding, the row copies and the cp.async helpers that every
// kernel shares (paged_decode_common.cuh's dispatch, paged_decode_sm90.cuh,
// paged_decode_wide.cu, flash_prefill.cu).
//
// Each kernel is built at a padded width, 64, 128 or 256 (`padded`), and
// takes the true head dim at run time. A head dim above 256 runs in panels
// of kPanel (256) columns: its scores sum over every panel, and each CTA
// owns one panel of the output (a column slab; `n_panels`). The pools and
// tensors keep their unpadded rows, so a row of hd elements starts only as
// aligned as its byte width allows (a bf16 row of 100 is 200 bytes, an int8
// row of 50 is 50, a bf16 row of 300 is 600): such rows are copied into
// their padded shared-memory slots in pieces of `row_piece(row_bytes)`
// bytes (`with_piece`, `copy_piece`). A panel starts kPanel elements into
// its row, a multiple of 16 bytes, so a row's pieces tile its panels too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPanel = 256;  // the widest built width, and a wide head's panel

// The width a head dim is built at: 64, 128 or 256; above 256 its width
// rounded up to whole panels (0: none, below 1).
__host__ __device__ constexpr int padded(int head_dim) {
  return head_dim < 1 ? 0 : head_dim <= 64 ? 64 : head_dim <= 128 ? 128
       : (head_dim + kPanel - 1) / kPanel * kPanel;
}

// Panels of kPanel columns a head dim spans: 1 up to 256.
__host__ __device__ constexpr int n_panels(int head_dim) {
  return (head_dim + kPanel - 1) / kPanel;
}

// The largest copy (16, 8, 4, 2 or 1 bytes) that every row of `row_bytes`
// bytes splits into on aligned addresses (the tensors are 16-byte aligned).
__host__ __device__ constexpr int row_piece(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4
       : row_bytes % 2 == 0 ? 2 : 1;
}

// f(std::integral_constant<int, G>) for G = row_piece(row_bytes), on rows
// of elements of kElem bytes: no piece is smaller than an element, so none
// smaller is built.
template <int kElem, int G = 16, typename F>
__device__ __forceinline__ void with_piece(int row_bytes, F&& f) {
  if constexpr (G == kElem) {
    f(std::integral_constant<int, G>{});
  } else if (row_piece(row_bytes) == G) {
    f(std::integral_constant<int, G>{});
  } else {
    with_piece<kElem, G / 2>(row_bytes, f);
  }
}

// cp.async groups: commit the copies this thread issued, and wait until at
// most N of its committed groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 16 bytes global to shared by cp.async; `_zfill`: 16 zero bytes where
// `pred` is false (`gmem` is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// G bytes global to shared, or G zero bytes where `pred` is false (`gmem`
// is then not read): cp.async for 16, 8 and 4 bytes (the caller commits the
// group or arrives on a barrier), a plain load and store for 2 and 1.
template <int G>
__device__ __forceinline__ void copy_piece(void* smem, const void* gmem, bool pred = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(pred ? 16 : 0));
  } else if constexpr (G >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(G), "r"(pred ? G : 0));
  } else if constexpr (G == 2) {
    *static_cast<uint16_t*>(smem) = pred ? *static_cast<const uint16_t*>(gmem) : uint16_t(0);
  } else {
    *static_cast<uint8_t*>(smem) = pred ? *static_cast<const uint8_t*>(gmem) : uint8_t(0);
  }
}

}  // namespace
