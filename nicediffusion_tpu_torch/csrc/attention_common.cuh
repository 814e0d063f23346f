// Shared by the attention kernels (attention.cu, attention_bwd.cu): the
// 64 x 64 score tile owned by 16 x 16 threads, the type conversions with
// the JAX kernels' rounding points, the 16-lane row reductions, and the
// channel offsets of q, k and v inside the fused (B, N, 3C) projection.
// resblock.cu takes the type conversions from here too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace nd {

constexpr int kBM = 64;        // query rows per tile
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTR = kBM / 16;  // score rows per thread: ty * kTR + i
constexpr int kTC = kBN / 16;  // score columns per thread: tx + 16 * j
constexpr int kPStride = kBN + 4;  // row stride of a shared score tile
constexpr float kMasked = -1e30f;  // finite, as in the TPU kernels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rounds to the input type and back, as the JAX kernels' .astype(dtype)
// before a product
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct QkvOffsets {
  int q, k, v;
};

// [q(C) | k(C) | v(C)] when split_first, else per head [h0:(q|k|v) | h1:...]
__device__ __forceinline__ QkvOffsets qkv_offsets(int head, int hc, int c, int split_first) {
  if (split_first) return {head * hc, c + head * hc, 2 * c + head * hc};
  const int base = head * 3 * hc;
  return {base, base + hc, base + 2 * hc};
}

// s[i][j] = sum_d a[ty*TR + i][d] * b[tx + 16*j][d] over two shared tiles
// with row stride HC + 1 (the one word of padding puts the 16 rows that 16
// lanes read into 16 banks): a 16*TR x 16*TC score tile, 64 x 64 unless a
// kernel asks for a smaller one
template <int HC, int TR = kTR, int TC = kTC>
__device__ __forceinline__ void tile_dot_nt(const float* a, const float* b, int ty, int tx,
                                            float (&s)[TR][TC]) {
  constexpr int kS = HC + 1;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HC; ++d) {
    float av[TR], bv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = a[(ty * TR + i) * kS + d];
#pragma unroll
    for (int j = 0; j < TC; ++j) bv[j] = b[(tx + 16 * j) * kS + d];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// tile_dot_nt without the zeroing: s[i][j] += the products of one 64-column
// chunk (row stride 65) of a head row, for the head dims above 256, whose
// sums run over several chunks
template <int TR = kTR, int TC = kTC>
__device__ __forceinline__ void tile_dot_nt_add(const float* a, const float* b, int ty, int tx,
                                                float (&s)[TR][TC]) {
  constexpr int kS = 64 + 1;
#pragma unroll 8
  for (int d = 0; d < 64; ++d) {
    float av[TR], bv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = a[(ty * TR + i) * kS + d];
#pragma unroll
    for (int j = 0; j < TC; ++j) bv[j] = b[(tx + 16 * j) * kS + d];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

}  // namespace nd
