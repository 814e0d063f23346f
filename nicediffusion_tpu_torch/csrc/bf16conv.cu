// The bf16 convolution of the sampling and serving forwards: bf16 x bf16 ->
// f32 sums on the tensor cores (wgmma), one launch a call, with a reduction
// order that no batch, row or batch mate changes.
//
// Replaces no TPU kernel. The JAX package computes its convs and dense
// products in XLA (flax nn.Conv and nn.Dense with dtype=bf16,
// nicediffusion_tpu/models/unet.py:243-250, 357-420). The port ran them
// through cuDNN and cuBLAS, whose bf16 engines may split K across blocks
// (split-K, stream-K) by a plan that sees the whole batch: a row's sum then
// depends on where it sits, and the serving daemon's promise that a (seed,
// label) gives the same image in any batch and row broke in bf16
// (tools/find_batch_variance.py names the calls). Here every output element
// is summed by one thread's accumulator in one order: taps in order, and
// inside a tap 32-channel steps in order, each step two wgmma k16 in order.
// Nothing splits K, and the plan (ops/kernels/conv.py::conv_nhwc_plan)
// picks the route and the filter tile from the conv's k, stride and F alone,
// never from the batch. So a row's output is a function of that row alone,
// bit for bit.
//
// For x (B, H, W, C) NHWC bf16, w (F, k, k, C) bf16 (channels innermost per
// filter and tap) and an optional bias (F,) bf16 it computes
//   acc = sum_{dy,dx,c} x[y s + dy - k/2, x s + dx - k/2, c] w[f, dy, dx, c]   f32
//   out = bf16(bf16(acc) + bias[f])
// with zero padding k / 2 and stride s of 1 or 2, k of 1 or 3: flax's
// rounding, the product rounded to bf16 and the bias added in bf16 (the two
// bf16 values summed in f32, exact, then one rounding). Without a bias,
// out = bf16(acc). A dense layer is a 1 x 1 conv over a (1, 1, M, C) view.
//
// What bounds it. Operations: 2 k^2 C F per output pixel against 2 (C + F)
// bytes, hundreds of operations a byte at the UNets' widths, above the
// card's ~295 for bf16 at 989 TFLOP/s and 3.35 TB/s: the tensor cores'
// rate. As in the int8 conv, the warps that multiply also stage, in
// lockstep with the products (queue B: a producer warpgroup, TMA).
//
// The design is the int8 conv's (int8conv.cu), without the quantize (what
// the two share is in conv_common.cuh): an implicit GEMM, M output pixels,
// N filters, K the k^2 taps x C channels; a block is two warpgroups (256
// threads), 64 output pixels each, sharing a filter tile of 64 NB (NB = 1,
// 2 or 3). The filter tiles of one pixel tile
// are consecutive blocks. The weights of one (tap, 32-channel step), 64 NB
// filters x 64 bytes, land by 16-byte cp.async in the 64-byte swizzle in a
// ring of 4 stages and are read by descriptor; every product is one wgmma
// m64n(64 NB)k16 per 16 channels. Channels past C, filters past F and pixels
// past the map are zeros (zero fill, or masked loads where C or the
// pointers allow no 16-byte copy); C, F, H and W are anything.
//
// The halo route (bf16_conv_halo_wgmma_kernel): stride 1, k = 3. Each
// warpgroup owns an 8 x 8 tile of output pixels and its 10 x 10 halo; the
// tiles of all examples are numbered in one sequence, and a pixel's place
// in its tile depends on its coordinates alone. A step's halo (100 pixels x
// 64 bytes) lands by cp.async straight into its swizzled buffer (chunk c of
// pixel p at chunk c ^ ((p / 2) % 4)); tap (dy, dx) is the halo shifted by
// (dy, dx), its m64k16 A fragments two ldmatrix.x4 a thread. A pair is one
// kernel row: a ring stage holds its three taps' slabs, and one barrier
// starts six wgmma a warpgroup. Two halo buffers: step s + 1's lands during
// step s's three pairs.
// The row route (bf16_conv_row_wgmma_kernel): k = 1, stride 2 and the dense
// view. M is linear, 128 output pixels a block, all examples in one
// sequence. A ring stage holds the slab and the im2col A tile (128 pixels x
// 32 channels of the tap's shifted input, by cp.async into the 64-byte
// swizzle), both read by descriptor.
// Epilogue (both): from the accumulators, the rounding above, the four lanes
// of a quad storing eight consecutive filters of a pixel as pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = nd::sm90;
using namespace nd::conv;
using bf16 = __nv_bfloat16;

constexpr int kStepC = kRowBytes / 2;    // channels a step: one 64-byte row
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
constexpr int kEpc = 8;           // bf16 elements a chunk
constexpr int kHalo = kHPx * kRowBytes;  // one halo buffer
constexpr int kHaloSlots = (kHPx * kChunks + kWgThreads - 1) / kWgThreads;
constexpr int kATile = kBM * kRowBytes;

struct Args : Shape {
  const bf16* x;
  const bf16* wt;
  const bf16* bias;  // null: no bias
  bf16* out;
};

template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB * 32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NB == 1) sm90::wgmma_rs_m64n64k16_bf16(d, a, b, 1);
  if constexpr (NB == 2) sm90::wgmma_rs_m64n128k16_bf16(d, a, b, 1);
  if constexpr (NB == 3) sm90::wgmma_rs_m64n192k16_bf16(d, a, b, 1);
}

template <int NB>
__device__ __forceinline__ void wgmma_ss(float (&d)[NB * 32], uint64_t a, uint64_t b) {
  if constexpr (NB == 1) sm90::wgmma_ss_m64n64k16_bf16(d, a, b, 1);
  if constexpr (NB == 2) sm90::wgmma_ss_m64n128k16_bf16(d, a, b, 1);
  if constexpr (NB == 3) sm90::wgmma_ss_m64n192k16_bf16(d, a, b, 1);
}

// The epilogue of a warpgroup's m64 x 64 NB tile. acc[32 cb + 4j + 2 half + e]
// is row 16 warp + lane / 4 + 8 half of the warpgroup, filter f0 + 64 cb + 8j
// + 2 (lane % 4) + e; pix[half] is that row's output pixel (its index over
// all examples), or -1 for a row that stores nothing.
template <int NB>
__device__ __forceinline__ void store_tile(const Args& a, const float (&acc)[NB * 32],
                                           const long long (&pix)[2], int f0, int lane) {
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 64 * cb + 8 * j + 2 * (lane % 4);
      if (col >= a.f) continue;
      const bool two = col + 1 < a.f;
      const float b0 = a.bias != nullptr ? __bfloat162float(a.bias[col]) : 0.f;
      const float b1 = a.bias != nullptr && two ? __bfloat162float(a.bias[col + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (pix[half] < 0) continue;
        float v0 = acc[32 * cb + 4 * j + 2 * half], v1 = acc[32 * cb + 4 * j + 2 * half + 1];
        if (a.bias != nullptr) {
          v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), b0);
          v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), b1);
        }
        bf16* dst = a.out + (size_t)pix[half] * a.f + col;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ------------------------------------------------------------- halo route

template <int NB>
struct HaloSmem {
  static constexpr int kStage = 3 * NB * kSlabBytes;  // the three taps of a kernel row
  static constexpr int kRing = kStages * kStage;
  static constexpr size_t kSmem = kRing + 2 * 2 * kHalo + 1024;  // two steps x two warpgroups
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// A thread's share of a warpgroup's halo: chunk ids wtid + 128 j of the 100
// pixels x 4 chunks of a step (pixel id / 4, chunk id % 4), with the offset
// of each into the tile's example at channel 0 and whether its pixel lies in
// the map, computed once
struct Halo {
  const bf16* xb;  // the tile's example
  long long goff[kHaloSlots];
  uint32_t in;     // bit j: slot j is a chunk of a pixel in the map
  int wtid;

  __device__ __forceinline__ void init(const Args& a, const Tile8& t, int wtid_) {
    wtid = wtid_;
    xb = a.x + (size_t)t.b * a.h * a.w * a.c;
    in = 0u;
#pragma unroll
    for (int j = 0; j < kHaloSlots; ++j) {
      const int id = wtid + kWgThreads * j, p = id / kChunks, chunk = id % kChunks;
      const int yy = t.y0 + p / kHSide - 1, xx = t.x0 + p % kHSide - 1;
      const bool inside = id < kHPx * kChunks && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
      in |= (uint32_t)inside << j;
      goff[j] = inside ? ((long long)yy * a.w + xx) * a.c + chunk * kEpc : 0;
    }
  }

  // channel step `step` into the swizzled halo buffer at buf; zeros outside
  // the map and past C
  __device__ __forceinline__ void stage(uint32_t buf, const Args& a, int step) const {
#pragma unroll
    for (int j = 0; j < kHaloSlots; ++j) {
      const int id = wtid + kWgThreads * j;
      if (id >= kHPx * kChunks) break;
      const int ch = step * kStepC + (id % kChunks) * kEpc;
      const int valid = (in >> j) & 1u ? min(max(a.c - ch, 0), kEpc) : 0;
      const bf16* src = valid > 0 ? xb + goff[j] + step * kStepC : xb;
      copy_chunk(buf + sm90::sw64_offset(id / kChunks, id % kChunks), src, 2 * valid, a.vec_x);
    }
  }
};

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    bf16_conv_halo_wgmma_kernel(const __grid_constant__ Args a) {
  using Sm = HaloSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wtid = tid % kWgThreads;
  const int wg = tid / kWgThreads, warp = wtid / 32, lane = tid % 32;
  const uint32_t halo0 = ring + Sm::kRing + wg * kHalo;
  auto halo_buf = [&](int s) { return halo0 + (uint32_t)((s & 1) * 2 * kHalo); };
  const int ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  const Tile8 t = tile_of((int)(blockIdx.x / ftiles) * 2 + wg, a);
  const int f0 = (int)(blockIdx.x % ftiles) * 64 * NB;
  const int steps = a.steps, iters = 3 * steps;  // (step, kernel row) pairs, rows fastest
  Slab<bf16, NB> slab;
  slab.init(a, f0, tid);
  Halo halo;
  halo.init(a, t, wtid);
  // the slabs of pair it, taps (dy, 0 to 2), into ring stage it % kStages
  auto stage_slabs = [&](int it) {
    if (it >= iters) return;
    const int step = it / 3, dy = it - 3 * step;
    const uint32_t st = ring + (uint32_t)((it % kStages) * Sm::kStage);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      slab.stage(st + (uint32_t)(dx * NB * kSlabBytes), a, a.wt, 3 * dy + dx, step);
  };
  // this lane's ldmatrix row: matrix j = lane / 8 holds rows 8 (j % 2) to
  // 8 (j % 2) + 7 of the warp's 16 (tile row 2 warp + j % 2, columns 0 to 7)
  // at bytes 16 (j / 2) to 16 (j / 2) + 15 of each k16 half
  const int mrow = 2 * warp + ((lane >> 3) & 1), mcol = lane & 7, khalf = lane >> 4;

  // prologue: step 0's halo with pair 0's slabs (one group), then the slabs
  // of pairs 1 and 2 (a group each)
  halo.stage(halo_buf(0), a, 0);
#pragma unroll 1
  for (int it = 0; it < kAhead; ++it) {
    stage_slabs(it);
    sm90::cp_async_commit();
  }

  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int step = it / 3, dy = it - 3 * step;
    // this pair's slabs (and at a step's first row its halo, staged with
    // the group of pair it - 3) landed in this thread's copies; the barrier
    // makes everyone's visible and says that the stage and the halo buffer
    // the loads below overwrite are free
    sm90::cp_async_wait<kAhead - 1>();
    sm90::fence_proxy_async();
    __syncthreads();
    // the A fragments of taps (dy, 0 to 2): the halo shifted by (dy, dx)
    uint32_t frag[3][2][4];
    const uint32_t hb = halo_buf(step);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int p = (mrow + dy) * kHSide + mcol + dx;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::ldmatrix_x4(frag[dx][kk], hb + (uint32_t)(p * kRowBytes) +
                                            (uint32_t)(((2 * kk + khalf) ^ ((p >> 1) & 3)) << 4));
    }
    uint32_t wst = ring + (uint32_t)((it % kStages) * Sm::kStage);
    asm volatile("" : "+r"(wst));
    sm90::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<NB>(acc, frag[dx][kk], sm90::sw64_desc(wst + dx * NB * kSlabBytes + kk * 32));
    sm90::wgmma_commit();
    // a step's first row: the halo of step + 1 into the buffer step - 1
    // read; every pair: the slabs of it + kAhead
    if (dy == 0 && step + 1 < steps) halo.stage(halo_buf(step + 1), a, step + 1);
    stage_slabs(it + kAhead);
    sm90::cp_async_commit();
    sm90::wgmma_wait<0>();
  }
  sm90::fence_regs(acc);

  if (!t.live) return;
  long long pix[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int yy = t.y0 + 2 * warp + half, xx = t.x0 + lane / 4;
    pix[half] = yy < a.h && xx < a.w ? ((long long)t.b * a.h + yy) * a.w + xx : -1;
  }
  store_tile<NB>(a, acc, pix, f0, lane);
}

// -------------------------------------------------------------- row route

template <int NB>
struct RowSmem {
  static constexpr int kStage = NB * kSlabBytes + kATile;  // the slab, then A
  static constexpr size_t kSmem = kStages * kStage + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

template <int NB>
__global__ void __launch_bounds__(kThreads, NB == 3 ? 1 : 2)
    bf16_conv_row_wgmma_kernel(const __grid_constant__ Args a) {
  using Sm = RowSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / kWgThreads, warp = (tid % kWgThreads) / 32;
  const int lane = tid % 32;
  const int ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  const long long m0 = (long long)(blockIdx.x / ftiles) * kBM;
  const int f0 = (int)(blockIdx.x % ftiles) * 64 * NB;
  Slab<bf16, NB> slab;
  slab.init(a, f0, tid);

  // this thread's A row r (output pixel m0 + r) and half hf of its chunks
  const int r = tid >> 1, hf = tid & 1;
  const long long m = m0 + r;
  const bool live = m < a.m;
  int img, iy, ix;
  {
    const long long per_img = (long long)a.ho * a.wo, mm = live ? m : 0;
    const long long b = mm / per_img;
    const int rem = (int)(mm - b * per_img), oy = rem / a.wo, ox = rem - oy * a.wo;
    img = (int)b;
    iy = oy * a.stride - a.pad;
    ix = ox * a.stride - a.pad;
  }

  // (tap, step) pairs, steps fastest
  const int iters = a.taps * a.steps;
  auto stage_pair = [&](int it) {
    if (it >= iters) return;
    const int tap = it / a.steps, step = it - tap * a.steps;
    const uint32_t st = ring + (uint32_t)((it % kStages) * Sm::kStage);
    slab.stage(st, a, a.wt, tap, step);
    const int dy = tap / a.k, dx = tap - dy * a.k, yy = iy + dy, xx = ix + dx;
    const bool in = live && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const bf16* src = a.x + (in ? (((size_t)img * a.h + yy) * a.w + xx) * a.c : 0);
    const uint32_t at = st + NB * kSlabBytes;
#pragma unroll
    for (int j = 0; j < kChunks / 2; ++j) {
      const int chunk = hf * (kChunks / 2) + j, c = step * kStepC + chunk * kEpc;
      const int valid = in ? min(max(a.c - c, 0), kEpc) : 0;
      copy_chunk(at + sm90::sw64_offset(r, chunk), valid > 0 ? src + c : a.x, 2 * valid,
                 a.vec_x);
    }
  };

#pragma unroll 1
  for (int it = 0; it < kAhead; ++it) {
    stage_pair(it);
    sm90::cp_async_commit();
  }

  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // pair it landed in this thread's copies; the barrier makes everyone's
    // visible and says that the stage pair it - 1 read is free
    sm90::cp_async_wait<kAhead - 1>();
    sm90::fence_proxy_async();
    __syncthreads();
    uint32_t st = ring + (uint32_t)((it % kStages) * Sm::kStage);
    uint32_t at = st + (uint32_t)(NB * kSlabBytes + wg * 64 * kRowBytes);
    asm volatile("" : "+r"(st), "+r"(at));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<NB>(acc, sm90::sw64_desc(at + kk * 32), sm90::sw64_desc(st + kk * 32));
    sm90::wgmma_commit();
    stage_pair(it + kAhead);
    sm90::cp_async_commit();
    sm90::wgmma_wait<0>();
  }
  sm90::fence_regs(acc);

  long long pix[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long mo = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * half;
    pix[half] = mo < a.m ? mo : -1;
  }
  store_tile<NB>(a, acc, pix, f0, lane);
}

// ---------------------------------------------------------------- launch

template <int NB>
cudaError_t launch_nb(const Args& a, int route, cudaStream_t stream) {
  if (route == 1)
    return launch(bf16_conv_halo_wgmma_kernel<NB>, HaloSmem<NB>::kSmem, grid_of<NB>(a, 1), a,
                  stream);
  return launch(bf16_conv_row_wgmma_kernel<NB>, RowSmem<NB>::kSmem, grid_of<NB>(a, 0), a,
                stream);
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC bf16; wt (f, k, k, c) bf16; bias (f,) bf16 or null;
// out (batch, ho, wo, f) bf16, ho = (h - 1) / stride + 1, the same for wo
// (padding k / 2). route 0 is the row route, 1 the halo route (k = 3,
// stride 1); filter_tile 64, 128 or 192. All on the current device. Returns
// the CUDA error code of the launch (0 on success).
int nd_bf16_conv(const void* x, const void* wt, const void* bias, void* out, int batch, int h,
                 int w, int c, int f, int k, int stride, int route, int filter_tile,
                 void* stream) {
  Args a;
  if (!make_shape(a, batch, h, w, c, f, k, stride, route, filter_tile, x, 2, wt, 2))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.wt = static_cast<const bf16*>(wt);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (filter_tile / 64) {
    case 1: return (int)launch_nb<1>(a, route, s);
    case 2: return (int)launch_nb<2>(a, route, s);
    default: return (int)launch_nb<3>(a, route, s);
  }
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
