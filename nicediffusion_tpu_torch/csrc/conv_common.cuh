// What the int8 conv (int8conv.cu) and the bf16 conv (bf16conv.cu) share,
// apart from the operand type: the geometry of a call and its checks, the
// block (two warpgroups), the numbering of the halo route's 8 x 8 output
// tiles, the weight slab of a ring stage, and the launch. What differs (the
// quantize, the wgmma shape, the A staging, the epilogue) stays in each file.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace nd {
namespace conv {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kWgThreads = 128;
constexpr int kRowBytes = 64;     // a channel step of a pixel or a filter: one 64-byte row
constexpr int kStages = 4;        // the ring: one stage multiplied, three landing
constexpr int kAhead = kStages - 1;  // pairs staged ahead of the one multiplied
constexpr int kSlabBytes = 64 * kRowBytes;  // 64 filters of a step: one NB unit of a slab
constexpr int kSide = 8;          // halo route: output tile side
constexpr int kHSide = kSide + 2;
constexpr int kHPx = kHSide * kHSide;  // halo pixels
constexpr int kBM = 2 * 64;       // row route: output pixels a block

// The geometry of a call: the head of each kernel's arguments
struct Shape {
  int h, w, c, f, k, stride, pad, ho, wo, taps, steps;
  long long m;       // output pixels, batch * ho * wo
  int tiles;         // halo route: 8 x 8 output tiles over all examples
  int vec_x, vec_w;  // x and the weights allow 16-byte copies
};

// s for x (batch, h, w, c) of x_bytes elements at x, f filters of k x k
// (w_bytes elements at wt) at stride 1 or 2, padding k / 2, on route 0
// (row) or 1 (halo: k = 3, stride 1) in filter tiles of 64, 128 or 192, and
// channel steps of one 64-byte row; false where the kernels take no such
// call or an index would pass INT_MAX.
inline bool make_shape(Shape& s, int batch, int h, int w, int c, int f, int k, int stride,
                       int route, int filter_tile, const void* x, int x_bytes, const void* wt,
                       int w_bytes) {
  const int nb = filter_tile / 64;
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || filter_tile % 64 != 0 || nb < 1 || nb > 3 ||
      route < 0 || route > 1 || (route == 1 && (k != 3 || stride != 1)) ||
      (long long)f * k * k * c > INT_MAX)
    return false;
  s.h = h, s.w = w, s.c = c, s.f = f, s.k = k, s.stride = stride, s.pad = k / 2;
  s.ho = (h + 2 * s.pad - k) / stride + 1;
  s.wo = (w + 2 * s.pad - k) / stride + 1;
  s.taps = k * k;
  const int step_c = kRowBytes / w_bytes;
  s.steps = (c + step_c - 1) / step_c;
  s.m = (long long)batch * s.ho * s.wo;
  const long long tiles = (long long)batch * ((h + kSide - 1) / kSide) * ((w + kSide - 1) / kSide);
  const long long ftiles = (f + filter_tile - 1) / filter_tile;
  if ((s.m + kBM - 1) / kBM * ftiles > INT_MAX || tiles > INT_MAX - 1 ||
      (tiles + 1) / 2 * ftiles > INT_MAX)
    return false;
  s.tiles = (int)tiles;
  // a 16-byte copy holds whole elements from a 16-byte boundary
  s.vec_x = c % (16 / x_bytes) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  s.vec_w = c % (16 / w_bytes) == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  return true;
}

// n (0 to 16) bytes from p, packed in four words, the rest zero
__device__ __forceinline__ uint4 load_bytes(const void* p, int n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) v[j / 4] |= (uint32_t)b[j] << (8 * (j % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// n (0 to 16) bytes from src into the 16-byte chunk at dst, zeros after: by
// cp.async where vec (src on 16 bytes), else by byte loads
__device__ __forceinline__ void copy_chunk(uint32_t dst, const void* src, int n, bool vec) {
  if (vec) {
    sm90::cp_async_16(dst, src, n);
  } else {
    const uint4 v = load_bytes(src, n);
    sm90::st_shared_16(dst, v.x, v.y, v.z, v.w);
  }
}

// The weight slab of a block: its 64 NB filters from f0 on, one 64-byte row
// each of one (tap, channel step), weights of type T laid out (F, k, k, C).
// A thread copies NB 16-byte chunks of it, chunk id tid + 256 i (filter f0 +
// id / 4, chunk id % 4 of the row); their offsets in the ring stage and into
// the weights are computed once.
template <typename T, int NB>
struct Slab {
  static constexpr int kStepC = kRowBytes / (int)sizeof(T);  // channels a step
  static constexpr int kEpc = 16 / (int)sizeof(T);           // elements a chunk
  uint32_t smem[NB];
  int gmem[NB];  // from (filter 0, tap 0, channel 0)
  int f0, tid;
  bool whole;    // every chunk whole and aligned: C a multiple of a step, the filters inside F

  __device__ __forceinline__ void init(const Shape& a, int f0_, int tid_) {
    f0 = f0_, tid = tid_;
    whole = a.vec_w && a.c % kStepC == 0 && a.f - f0 >= 64 * NB;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int id = tid + kThreads * i, r = id >> 2, q = id & 3;
      smem[i] = sm90::sw64_offset(r, q);
      gmem[i] = whole ? (f0 + r) * a.taps * a.c + kEpc * q : 0;
    }
  }

  // slab (tap, step) of the weights wt into the ring stage at dst; the
  // caller commits. A ragged slab masks filters past F and channels past C,
  // by byte loads where no 16-byte copy is aligned.
  __device__ __forceinline__ void stage(uint32_t dst, const Shape& a, const T* wt, int tap,
                                        int step) const {
    const int base = tap * a.c + step * kStepC;
    if (whole) {
#pragma unroll
      for (int i = 0; i < NB; ++i) sm90::cp_async_16(dst + smem[i], wt + gmem[i] + base, 16);
      return;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int id = tid + kThreads * i, fl = f0 + (id >> 2), c = step * kStepC + kEpc * (id & 3);
      const int valid = fl < a.f ? min(max(a.c - c, 0), kEpc) : 0;
      const T* p = valid > 0 ? wt + ((long long)fl * a.taps + tap) * a.c + c : wt;
      copy_chunk(dst + smem[i], p, valid * (int)sizeof(T), a.vec_w);
    }
  }
};

// a warpgroup's 8 x 8 output tile of the halo route: example, top-left
// pixel, and whether it exists (a block's second warpgroup past the last
// tile computes the last tile again and stores nothing)
struct Tile8 {
  int b, y0, x0;
  bool live;
};

__device__ __forceinline__ Tile8 tile_of(int s, const Shape& a) {
  Tile8 t;
  t.live = s < a.tiles;
  s = min(s, a.tiles - 1);
  const int tx = (a.w + kSide - 1) / kSide;
  const int per = tx * ((a.h + kSide - 1) / kSide);
  t.b = s / per;
  const int r = s - t.b * per;
  t.y0 = (r / tx) * kSide;
  t.x0 = (r % tx) * kSide;
  return t;
}

// the grid of a call: the halo route's blocks hold two tiles, the row
// route's kBM pixels, each times the filter tiles of 64 NB
template <int NB>
dim3 grid_of(const Shape& a, int route) {
  const long long ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  return dim3((unsigned)(route == 1 ? (long long)(a.tiles + 1) / 2 * ftiles
                                    : (a.m + kBM - 1) / kBM * ftiles));
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace nd
