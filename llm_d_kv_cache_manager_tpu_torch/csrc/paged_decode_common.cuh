// What the decode sources share (paged_decode.cu, paged_decode_tiled.cu,
// paged_decode_wide.cu and paged_decode_combine.cuh): how a GQA group maps
// onto CTAs (`n_chunks_of`, `rows_of`, `chunk_rows`), the dispatch over the
// built (padded head_dim, rows) instantiations of the Hopper decode body of
// paged_decode_sm90.cuh (`with_sm90_shape`), and the element conversions
// (`to_f`, `from_f`). Every decode up to head_dim 256, bf16 or f32 q on any
// page format, runs paged_decode_sm90.cuh's body; wider heads run
// paged_decode_wide.cu's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "row_copy.cuh"  // padded, row_piece, with_piece, copy_piece, cp_async_*

namespace {

// A decode CTA holds at most max_rows_of(head_dim) query heads (the sm90
// body keeps q and acc for each in registers: 8 up to head_dim 128, 4 above,
// where a lane holds 16 columns). A GQA group above that runs as
// n_chunks_of chunks of rows_of rows each over the same kv head, one more
// CTA (or cluster) per chunk: group 12 as 2 x 6, 16 as 2 x 8, 13 as 2 x 7
// (the last chunk's seventh row does not exist), 71 as 9 x 8. Each chunk
// reads the kv head's pages again, so a group of g > 8 moves ceil(g / 8)
// times the K/V bytes of one pass. ops/paged_attention.py (`group_chunks`)
// follows the same rule.
constexpr int kMaxRows = 8;
__host__ __device__ constexpr int max_rows_of(int head_dim) {
  return head_dim > 128 ? kMaxRows / 2 : kMaxRows;
}
__host__ __device__ constexpr int n_chunks_of(int group, int head_dim) {
  return (group + max_rows_of(head_dim) - 1) / max_rows_of(head_dim);
}
__host__ __device__ constexpr int rows_of(int group, int head_dim) {
  return (group + n_chunks_of(group, head_dim) - 1) / n_chunks_of(group, head_dim);
}

// Grid row y of a decode launch is the pair (kv head h, chunk): the chunk's
// first query row in the sequence's q, and how many of its `rows` (rows_of)
// exist. (No chunk is empty, so a group runs in ceil(group / rows) chunks.)
struct ChunkRows {
  int h, row0, n_rows;
};
__device__ __forceinline__ ChunkRows chunk_rows(int y, int group, int rows) {
  const int n_chunks = (group + rows - 1) / rows;
  const int h = y / n_chunks;
  const int chunk = y % n_chunks;
  return {h, h * group + chunk * rows, min(rows, group - chunk * rows)};
}

// launch(std::integral_constant<int, HD>, std::integral_constant<int, ROWS>)
// for the instantiation that serves head_dim (HD its padded width) and rows;
// cudaErrorInvalidValue for a shape no kernel is built for.
template <int ROWS, typename F>
cudaError_t with_head_dim(int head_dim, F& launch) {
  switch (padded(head_dim)) {
    case 64:
      return launch(std::integral_constant<int, 64>{}, std::integral_constant<int, ROWS>{});
    case 128:
      return launch(std::integral_constant<int, 128>{}, std::integral_constant<int, ROWS>{});
    case 256:
      if constexpr (ROWS <= max_rows_of(256)) {
        return launch(std::integral_constant<int, 256>{}, std::integral_constant<int, ROWS>{});
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}
// launch(std::integral_constant<int, HD>) for head_dim's padded width.
template <typename F>
cudaError_t with_padded(int head_dim, F&& launch) {
  switch (padded(head_dim)) {
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}
template <typename F>
cudaError_t with_shape(int head_dim, int rows, F&& launch) {
  switch (rows) {
    case 1: return with_head_dim<1>(head_dim, launch);
    case 2: return with_head_dim<2>(head_dim, launch);
    case 3: return with_head_dim<3>(head_dim, launch);
    case 4: return with_head_dim<4>(head_dim, launch);
    case 5: return with_head_dim<5>(head_dim, launch);
    case 6: return with_head_dim<6>(head_dim, launch);
    case 7: return with_head_dim<7>(head_dim, launch);
    case 8: return with_head_dim<8>(head_dim, launch);
    default: return cudaErrorInvalidValue;
  }
}
// launch(std::integral_constant<int, HD>, std::integral_constant<int, ROWS>,
// std::bool_constant<BULK>) for the Hopper body's instantiation that serves
// head_dim and a chunk of `rows` query heads. At the padded width (BULK: the
// rows are whole 16-byte multiples, one bulk copy a page piece) it is built
// for every rows, as the shape. Below it (rows copied in pieces) it is built
// at ROWS 1 (a group of 1) and at max_rows_of(HD) for every other group,
// the chunk's rows then passed at run time: 6 instantiations a (q dtype,
// page format) where the rows would take 20, which keeps the build short, at
// the cost of idle rows' arithmetic for groups of 2 to 7 at such head dims.
template <typename F>
cudaError_t with_sm90_shape(int head_dim, int rows, F&& launch) {
  if (head_dim == padded(head_dim)) {
    return with_shape(head_dim, rows, [&](auto hd, auto r) {
      return launch(hd, r, std::true_type{});
    });
  }
  return with_padded(head_dim, [&](auto hd) {
    constexpr int kMost = max_rows_of(decltype(hd)::value);
    return rows == 1 ? launch(hd, std::integral_constant<int, 1>{}, std::false_type{})
                     : launch(hd, std::integral_constant<int, kMost>{}, std::false_type{});
  });
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace
