// The int8 convolution of static int8 serving: s8 x s8 -> s32 on the tensor
// cores (wgmma), the activation quantized on its way into shared memory and
// the dequantization in the epilogue: one launch a call.
//
// Replaces XLA's int8 convolution in nicediffusion_tpu/ops/quant.py ::
// int8_conv_static (:87; lax.conv_general_dilated on int8 operands with
// int32 sums, no pallas_call), and the products of int8_conv, int8_dense and
// int8_dense_static (a dense layer is a 1 x 1 conv over a (1, 1, M, C) view).
// For x (B, H, W, C) NHWC, the frozen weights kernel_q (F, k, k, C) s8, a
// static scale inv_act, deq (F,) f32 and an optional bias (F,) f32 it computes
//   x_q = clip(rint(x * inv_act), -127, 127)            f32 product, s8
//   s   = sum_{dy,dx,c} x_q[y s + dy - k/2, x s + dx - k/2, c] * kernel_q[f, dy, dx, c]
//   out = round_to_out(float(s) * deq[f] + bias[f])       in s32, then f32
// with zero padding k / 2 (after the quantization: zeros stay zeros), stride s
// of 1 or 2, k of 1 or 3. x is f32 or bf16; or s8, taken as already
// quantized (the dynamic path quantizes by division in torch, as the JAX
// package does, and x * (1 / s) can round differently from x / s). rint is
// round-half-to-even, jnp.round's rule. The sums are exact, so any tiling
// gives the same ones; the f32 product and sum of the epilogue are each
// rounded once (no FMA contraction), as XLA rounds them. An optional raw
// output receives the s32 sums themselves.
//
// What bounds it. Operations: 2 k^2 C F per output pixel against (C + F)
// bytes of int8 per pixel, hundreds to thousands of operations a byte at the
// UNets' widths, above the card's ~590 for int8 at 1,979 TOPS and 3.35 TB/s:
// the tensor cores' int8 rate, twice the bf16 one. Inside the card the
// work the warps do besides the products holds it back (the end of this note).
//
// Shared by both routes. An implicit GEMM: M output pixels, N filters, K the
// k^2 taps x C channels walked 64 channels (one 64-byte s8 row a pixel or a
// filter) a step, so no C that is a multiple of 64 (every openai_64 conv)
// multiplies a zero. A block is two warpgroups (256 threads), 64 output
// pixels each (one wgmma row block), sharing a filter tile of 64 NB (NB = 1,
// 2 or 3; int8_conv_plan in ops/kernels/int8conv.py picks the route and NB,
// by waves among the widths that divide F when one does). The filter tiles
// of one pixel tile are consecutive blocks, so they run together and read x
// from device memory once. The weights of one (tap, 64-channel step), 64 NB
// filters x 64 bytes, K-major as they are frozen, land by 16-byte cp.async
// in the 64-byte swizzle in a ring of 4 stages (three pairs in flight while
// one is multiplied) and are read by descriptor; every product is one wgmma
// m64n(64 NB)k32 per 32 channels. Channels past C, filters past F and pixels
// past the map are zeros (zero fill, or masked byte loads where C or the
// pointers allow no 16-byte copy); C, F, H and W are anything. The bf16
// conv (bf16conv.cu) has the same design: what does not depend on the
// operand type (the geometry, the tile numbering, the weight slab, the
// launch) is in conv_common.cuh.
//
// The halo route (int8_conv_halo_wgmma_kernel): stride 1, k = 3, bf16 or s8 x,
// 96% of an openai_64 int8 forward's operations. Built as K4
// (resblock.cu). Each warpgroup owns an 8 x 8 tile of output pixels and its
// 10 x 10 halo; the tiles of all examples are numbered in one sequence, so
// at 8 x 8 maps a block's two warpgroups may serve two examples.
//   * A halo's channel step lands raw (bf16 or s8, zeros outside the map)
//     by 16-byte cp.async (each thread's chunks and their offsets fixed
//     once) into a raw buffer, and is quantized from there into an s8
//     buffer by clip(rint(x * inv_act)) (an s8 x is copied): a pixel is a
//     64-byte row whose 16-byte chunk c lies at chunk c ^ ((pixel / 2) % 4),
//     so the eight pixels of an ldmatrix 8 x 8 read fall on eight bank
//     groups. No separate quantize pass and no s8 copy of x in device memory.
//   * A from registers: tap (dy, dx) is the halo shifted by (dy, dx), its
//     m64k32 fragments two ldmatrix.x4 a thread straight into the wgmma
//     register layout; each input element is read from L2 once a step, not
//     once a tap. A shifted window is no swizzle-atom-aligned descriptor
//     operand, which is why A is not read by descriptor.
//   * A pair is one kernel row: a ring stage holds its three taps' slabs,
//     and one barrier starts six wgmma a warpgroup (one tap a barrier, as
//     K4 does, measured slower here: PERF.md).
//   * Overlap: two raw and two s8 buffers. While step s multiplies, the raw
//     halo of step s + 2 lands (staged at the step's first row) and each
//     thread quantizes its (at most four) 16-channel chunks of step s + 1,
//     two after each of the other rows' products start; then it waits for
//     the products.
//   * Operations per byte from L2: a step brings 9 slabs of 64 NB x 64 bytes
//     and two raw halos (100 pixels x 128 bytes in bf16) for 2 x 9 x 64 x
//     64 NB x 64 x 2 operations: 208 a byte at NB = 3, against 128 for the
//     im2col design this replaced.
//   * Shared memory at NB = 3: 144 KB of ring, 50 KB of raw, 25 KB of s8
//     halos (bf16 x): one block a multiprocessor (so at every NB).
// The row route (int8_conv_row_wgmma_kernel): k = 1, stride 2, f32 x and the
// (1, 1, M, C) view of a dense layer: 4% of the openai_64 work, and the f32
// test path. M is linear: 128 output pixels a block, all examples in one
// sequence. A ring stage holds the slab and the raw im2col A tile (128
// pixels x 64 channels of the tap's shifted input as x lies, by cp.async);
// each thread stages half a row and quantizes that same half into one of
// two s8 A tiles (64-byte swizzle, read by descriptor) once its own copies
// are in, so it needs no barrier for it. f32 x takes this route at any
// shape: it is the tests' path, not the served one, and its raw halo would
// double the halo route's shared memory.
// Epilogue (both): from the accumulators, float(s) * deq plus the bias, one
// rounding to the output type, the four lanes of a quad storing eight
// consecutive filters of a pixel (16 bytes in bf16) as pairs; the raw sums
// the same way.
// Registers and spills: ptxas's report for each instance (chip_smoke.py
// [build]; CUDA 12.8: 224 a thread for bf16 x at NB = 3, no spill).
//
// What holds it back (tools/ablate_int8conv.py, PERF.md): the halo loop
// with its products left out takes most of the loop's time, and the raw
// staging, the slab staging, the quantize and the barrier each take a
// tenth or more: the warps that multiply also stage and quantize, in
// lockstep with the products. The INT8CONV_SKIP_* macros below leave one of
// them out for that tool (the sums are then wrong); the package's build
// never defines them. Tried in the redesign and not kept, being slower: two
// tiles a warpgroup at one tap a barrier; one wgmma group kept in flight
// across the barrier (ptxas serialises the register-A products); two
// row-route blocks a multiprocessor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_common.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = nd::sm90;
using namespace nd::conv;

constexpr int kKStep = kRowBytes;        // channels a step: one 64-byte s8 row
constexpr int kQHalo = kHPx * kKStep;    // an s8 halo buffer
constexpr int kQTasks = kHPx * 4;        // (pixel, 16-channel chunk) quantize tasks of a step
constexpr int kQSlots = (kQTasks + kWgThreads - 1) / kWgThreads;  // a thread's, at most
static_assert(kQSlots <= 4, "a step's quantize runs two tasks after each of kernel rows 1 and 2");
constexpr int kATile = kBM * kKStep;

enum { kF32 = 0, kBF16 = 1, kS8 = 2 };

struct Args : Shape {
  const void* x;
  const float* inv_act;  // null for an s8 x
  const int8_t* wq;
  const float* deq;
  const float* bias;     // null: no bias
  void* out;             // null: no dequantized output
  int* raw;              // null: no raw sums
  int otype;
};

template <int XT>
struct XType;
template <>
struct XType<kF32> {
  using T = float;
};
template <>
struct XType<kBF16> {
  using T = __nv_bfloat16;
};
template <>
struct XType<kS8> {
  using T = int8_t;
};

// rint(v * inv) clipped to [-127, 127], as an s32: the f32 product rounded
// once, then round-half-to-even. Clipping the product to +-127 first gives
// the same integer (the bounds are integers, both steps monotone).
__device__ __forceinline__ int quant8(float v, float inv) {
  return __float2int_rn(fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f));
}

// four values in [-127, 127] packed into one word, the first in the low byte
// (cvt.pack: d = {c[15:0], a[7:0], b[7:0]}, each of a and b saturated to s8)
__device__ __forceinline__ uint32_t pack4(int v0, int v1, int v2, int v3) {
  uint32_t hi, d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, 0;" : "=r"(hi) : "r"(v3), "r"(v2));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(v1), "r"(v0), "r"(hi));
  return d;
}

// 16 bytes of s8 from 32 bytes of bf16 (eight values a word pair). The
// product's upper clip is left to cvt.pack's saturation: rint of a product
// over 127 is at least 127.
__device__ __forceinline__ uint4 quant_bf16x16(uint4 lo, uint4 hi, float inv) {
  const uint32_t in[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int q[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q[2 * i] = __float2int_rn(fmaxf(__fmul_rn(sm90::bf16_lo(in[i]), inv), -127.f));
    q[2 * i + 1] = __float2int_rn(fmaxf(__fmul_rn(sm90::bf16_hi(in[i]), inv), -127.f));
  }
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

template <int NB>
__device__ __forceinline__ void wgmma_rs(int (&d)[NB * 32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NB == 1) sm90::wgmma_rs_m64n64k32_s8(d, a, b, 1);
  if constexpr (NB == 2) sm90::wgmma_rs_m64n128k32_s8(d, a, b, 1);
  if constexpr (NB == 3) sm90::wgmma_rs_m64n192k32_s8(d, a, b, 1);
}

template <int NB>
__device__ __forceinline__ void wgmma_ss(int (&d)[NB * 32], uint64_t a, uint64_t b) {
  if constexpr (NB == 1) sm90::wgmma_ss_m64n64k32_s8(d, a, b, 1);
  if constexpr (NB == 2) sm90::wgmma_ss_m64n128k32_s8(d, a, b, 1);
  if constexpr (NB == 3) sm90::wgmma_ss_m64n192k32_s8(d, a, b, 1);
}

// s = float(sum) * deq (+ bias), one rounding to the output type; two
// filters at a time where both exist and F is even (aligned pairs)
__device__ __forceinline__ float dequant(const Args& a, int s, float deq, float bias) {
  float v = __fmul_rn(__int2float_rn(s), deq);
  return a.bias != nullptr ? __fadd_rn(v, bias) : v;
}

// The epilogue of a warpgroup's m64 x 64 NB tile. acc[32 cb + 4j + 2 half + e]
// is row 16 warp + lane / 4 + 8 half of the warpgroup, filter f0 + 64 cb + 8j
// + 2 (lane % 4) + e; pix[half] is that row's output pixel (its index over
// all examples), or -1 for a row that stores nothing.
template <int NB>
__device__ __forceinline__ void store_tile(const Args& a, const int (&acc)[NB * 32],
                                           const long long (&pix)[2], int f0, int lane) {
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 64 * cb + 8 * j + 2 * (lane % 4);
      if (col >= a.f) continue;
      const bool two = col + 1 < a.f;
      const float d0 = __ldg(a.deq + col), d1 = two ? __ldg(a.deq + col + 1) : 0.f;
      const float b0 = a.bias != nullptr ? __ldg(a.bias + col) : 0.f;
      const float b1 = a.bias != nullptr && two ? __ldg(a.bias + col + 1) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (pix[half] < 0) continue;
        const int s0 = acc[32 * cb + 4 * j + 2 * half], s1 = acc[32 * cb + 4 * j + 2 * half + 1];
        const size_t o = (size_t)pix[half] * a.f + col;
        if (a.raw != nullptr) {
          if (two && pairs) {
            *reinterpret_cast<int2*>(a.raw + o) = make_int2(s0, s1);
          } else {
            a.raw[o] = s0;
            if (two) a.raw[o + 1] = s1;
          }
        }
        if (a.out == nullptr) continue;
        const float v0 = dequant(a, s0, d0, b0), v1 = dequant(a, s1, d1, b1);
        if (a.otype == kF32) {
          float* dst = static_cast<float*>(a.out) + o;
          if (two && pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (two) dst[1] = v1;
          }
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + o;
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (two) dst[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
}

// ------------------------------------------------------------- halo route

template <int XT>
struct HaloTile {
  using T = typename XType<XT>::T;
  static constexpr int kRawPx = kKStep * sizeof(T);  // raw bytes a pixel and step
  static constexpr int kRaw = kHPx * kRawPx;
  static constexpr int kEpc = 16 / sizeof(T);        // elements a 16-byte chunk
};

template <int XT, int NB>
struct HaloSmem {
  static constexpr int kStage = 3 * NB * kSlabBytes;  // the three taps of a kernel row
  static constexpr int kRing = kStages * kStage;
  static constexpr int kRaws = 2 * 2 * HaloTile<XT>::kRaw;  // two steps x two warpgroups
  static constexpr int kQs = 2 * 2 * kQHalo;
  static constexpr size_t kSmem = kRing + kRaws + kQs + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// A thread's share of a warpgroup's raw halo: chunk ids wtid + 128 j of
// the 100 pixels x kChunks 16-byte chunks of a step (pixel id / kChunks,
// chunk id % kChunks, stored at byte 16 id of the raw buffer), with the
// offset of each into the tile's example at channel 0 and whether its pixel
// lies in the map, computed once
template <int XT>
struct RawHalo {
  using H = HaloTile<XT>;
  using T = typename H::T;
  static constexpr int kChunks = H::kRawPx / 16;
  static constexpr int kSlots = (kHPx * kChunks + kWgThreads - 1) / kWgThreads;
  const T* xb;     // the tile's example
  int goff[kSlots];
  uint32_t in;     // bit j: slot j is a chunk of a pixel in the map
  int wtid;

  __device__ __forceinline__ void init(const Args& a, const Tile8& t, int wtid_) {
    wtid = wtid_;
    xb = static_cast<const T*>(a.x) + (size_t)t.b * a.h * a.w * a.c;
    in = 0u;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int id = wtid + kWgThreads * j, p = id / kChunks, chunk = id % kChunks;
      const int yy = t.y0 + p / kHSide - 1, xx = t.x0 + p % kHSide - 1;
      const bool inside = id < kHPx * kChunks && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
      in |= (uint32_t)inside << j;
      goff[j] = inside ? (yy * a.w + xx) * a.c + chunk * H::kEpc : 0;
    }
  }

  // channel step `step` into the raw buffer at raw; zeros outside the map
  // and past C
  __device__ __forceinline__ void stage(uint32_t raw, const Args& a, int step) const {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int id = wtid + kWgThreads * j;
      if (id >= kHPx * kChunks) break;
      const int ch = step * kKStep + (id % kChunks) * H::kEpc;
      const int valid = (in >> j) & 1u ? min(max(a.c - ch, 0), H::kEpc) : 0;  // elements
      const T* src = valid > 0 ? xb + goff[j] + step * kKStep : xb;
      copy_chunk(raw + (uint32_t)(16 * id), src, valid * (int)sizeof(T), a.vec_x);
    }
  }
};

// quantize task `task` of a step: pixel task / 4, channels 16 (task % 4) on,
// from the raw buffer into the swizzled s8 buffer (a copy for an s8 x)
template <int XT>
__device__ __forceinline__ void quantize_task(uint32_t q, uint32_t raw, int task, float inv) {
  const int p = task >> 2, chunk = task & 3;
  uint4 v;
  if constexpr (XT == kS8) {
    v = sm90::ld_shared_16(raw + (uint32_t)(p * kKStep + chunk * 16));
  } else {
    const uint32_t at = raw + (uint32_t)(p * HaloTile<XT>::kRawPx + chunk * 32);
    v = quant_bf16x16(sm90::ld_shared_16(at), sm90::ld_shared_16(at + 16), inv);
  }
  sm90::st_shared_16(q + sm90::sw64_offset(p, chunk), v.x, v.y, v.z, v.w);
}

template <int XT, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_halo_wgmma_kernel(const __grid_constant__ Args a) {
  using Sm = HaloSmem<XT, NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wtid = tid % kWgThreads;
  const int wg = tid / kWgThreads, warp = wtid / 32, lane = tid % 32;
  const uint32_t raw0 = ring + Sm::kRing + wg * HaloTile<XT>::kRaw;
  const uint32_t q0 = ring + Sm::kRing + Sm::kRaws + wg * kQHalo;
  auto raw_buf = [&](int s) { return raw0 + (uint32_t)((s & 1) * 2 * HaloTile<XT>::kRaw); };
  auto q_buf = [&](int s) { return q0 + (uint32_t)((s & 1) * 2 * kQHalo); };
  // the filter tiles of one pair of pixel tiles are consecutive blocks, so
  // that they run together and x's halo comes from device memory once
  const int ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  const Tile8 t = tile_of((int)(blockIdx.x / ftiles) * 2 + wg, a);
  const int f0 = (int)(blockIdx.x % ftiles) * 64 * NB;
  const int steps = a.steps, iters = 3 * steps;  // (step, kernel row) pairs, rows fastest
  const float inv = XT == kS8 ? 0.f : __ldg(a.inv_act);
  Slab<int8_t, NB> slab;
  slab.init(a, f0, tid);
  RawHalo<XT> halo;
  halo.init(a, t, wtid);
  // the slabs of pair it, taps (dy, 0 to 2), into ring stage it % kStages
  auto stage_slabs = [&](int it) {
    if (it >= iters) return;
    const int step = it / 3, dy = it - 3 * step;
    const uint32_t st = ring + (uint32_t)((it % kStages) * Sm::kStage);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      slab.stage(st + (uint32_t)(dx * NB * kSlabBytes), a, a.wq, 3 * dy + dx, step);
  };
  // this lane's ldmatrix row: matrix j = lane / 8 holds rows 8 (j % 2) to
  // 8 (j % 2) + 7 of the warp's 16 (tile row 2 warp + j % 2, columns 0 to 7)
  // at bytes 16 (j / 2) to 16 (j / 2) + 15 of each k32 half
  const int mrow = 2 * warp + ((lane >> 3) & 1), mcol = lane & 7, khalf = lane >> 4;

  // prologue: the raw halos of steps 0 and 1 (one group), the slabs of the
  // first kAhead pairs (a group each); then step 0 quantized
  halo.stage(raw_buf(0), a, 0);
  if (steps > 1) halo.stage(raw_buf(1), a, 1);
  sm90::cp_async_commit();
#pragma unroll 1
  for (int it = 0; it < kAhead; ++it) {
    stage_slabs(it);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kAhead>();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < kQSlots; ++j) {
    const int task = wtid + kWgThreads * j;
    if (task < kQTasks) quantize_task<XT>(q_buf(0), raw_buf(0), task, inv);
  }

  int acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int step = it / 3, dy = it - 3 * step;
    // this pair's slabs landed (this thread's copies); the barrier makes
    // everyone's visible, says that the stage the loads below overwrite is
    // free and that this step's s8 halo is written
    sm90::cp_async_wait<kAhead - 1>();
    sm90::fence_proxy_async();
#ifndef INT8CONV_SKIP_BARRIER
    __syncthreads();
#endif
    // the A fragments of taps (dy, 0 to 2): the halo shifted by (dy, dx)
    uint32_t frag[3][2][4];
    const uint32_t qb = q_buf(step);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int p = (mrow + dy) * kHSide + mcol + dx;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::ldmatrix_x4(frag[dx][kk], qb + (uint32_t)(p * kKStep) +
                                            (uint32_t)(((2 * kk + khalf) ^ ((p >> 1) & 3)) << 4));
    }
    // the stage base, opaque to the compiler, so that it rebuilds each
    // descriptor with an add instead of holding them in registers
    uint32_t wst = ring + (uint32_t)((it % kStages) * Sm::kStage);
    asm volatile("" : "+r"(wst));
    sm90::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#ifndef INT8CONV_SKIP_PRODUCTS
        wgmma_rs<NB>(acc, frag[dx][kk], sm90::sw64_desc(wst + dx * NB * kSlabBytes + kk * 32));
#else
        acc[2 * dx + kk] += (int)frag[dx][kk][0];
#endif
    sm90::wgmma_commit();
    // a step's first row: the raw halo of step + 2 into the raw buffer step
    // was quantized from; every pair: the slabs of it + kAhead
#ifndef INT8CONV_SKIP_RAW
    if (dy == 0 && step + 2 < steps) halo.stage(raw_buf(step), a, step + 2);
#endif
#ifndef INT8CONV_SKIP_SLABS
    stage_slabs(it + kAhead);
#endif
    sm90::cp_async_commit();
    // kernel rows 1 and 2: quantize tasks 2 dy - 2 and 2 dy - 1 of step + 1
    // (its raw halo landed: its group is older than the one waited for
    // above); row 0 staged a raw halo
#ifndef INT8CONV_SKIP_QUANTIZE
    if (dy > 0 && step + 1 < steps)
#else
    if (false)
#endif
#pragma unroll
      for (int j = 2 * dy - 2; j < 2 * dy; ++j) {
        const int task = wtid + kWgThreads * j;
        if (task < kQTasks) quantize_task<XT>(q_buf(step + 1), raw_buf(step + 1), task, inv);
      }
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

template <int XT, int NB>
struct RowSmem {
  using T = typename XType<XT>::T;
  static constexpr int kRawRow = kKStep * sizeof(T);  // raw bytes of a pixel's step
  static constexpr int kRawChunks = kRawRow / 16;
  static constexpr int kStage = NB * kSlabBytes + kBM * kRawRow;  // the slab, then raw A
  static constexpr size_t kSmem = kStages * kStage + 2 * kATile + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// byte offset of raw chunk `chunk` of A row r: the chunk index XORed with
// the row's low bits, so that the threads of a quarter warp, each on its own
// row, read different bank groups
template <int XT, int NB>
__device__ __forceinline__ uint32_t raw_offset(int r, int chunk) {
  using Sm = RowSmem<XT, NB>;
  return (uint32_t)(r * Sm::kRawRow + ((chunk ^ (r & (Sm::kRawChunks - 1) & 7)) << 4));
}

template <int XT, int NB>
__global__ void __launch_bounds__(kThreads, NB == 3 ? 1 : 2)
    int8_conv_row_wgmma_kernel(const __grid_constant__ Args a) {
  using Sm = RowSmem<XT, NB>;
  using T = typename Sm::T;
  constexpr int kEpc = 16 / sizeof(T);           // elements a 16-byte chunk
  constexpr int kHalfChunks = Sm::kRawChunks / 2;  // a thread's chunks of its row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qa = ring + kStages * Sm::kStage;  // two s8 A tiles
  const int tid = threadIdx.x, wg = tid / kWgThreads, warp = (tid % kWgThreads) / 32;
  const int lane = tid % 32;
  // the filter tiles of one pixel tile are consecutive blocks (as above)
  const int ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  const long long m0 = (long long)(blockIdx.x / ftiles) * kBM;
  const int f0 = (int)(blockIdx.x % ftiles) * 64 * NB;
  const float inv = XT == kS8 ? 0.f : __ldg(a.inv_act);
  Slab<int8_t, NB> slab;
  slab.init(a, f0, tid);

  // this thread's A row r (output pixel m0 + r) and half hf of its channels:
  // it stages that half raw and quantizes it itself, so it reads only its
  // own copies
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
    slab.stage(st, a, a.wq, tap, step);
    const int dy = tap / a.k, dx = tap - dy * a.k, yy = iy + dy, xx = ix + dx;
    const bool in = live && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const int c0 = step * kKStep + hf * (kKStep / 2);
    const T* src = static_cast<const T*>(a.x) +
                   (in ? (((size_t)img * a.h + yy) * a.w + xx) * a.c : 0);
    const uint32_t raw = st + NB * kSlabBytes;
#pragma unroll
    for (int j = 0; j < kHalfChunks; ++j) {
      const int c = c0 + j * kEpc;
      const int valid = in ? min(max(a.c - c, 0), kEpc) : 0;
      const T* p = valid > 0 ? src + c : static_cast<const T*>(a.x);
      copy_chunk(raw + raw_offset<XT, NB>(r, hf * kHalfChunks + j), p, valid * (int)sizeof(T),
                 a.vec_x);
    }
  };
  // pair it's raw A half, quantized into s8 A tile it % 2: channels 16 j of
  // the step for j = 2 hf, 2 hf + 1
  auto quantize_a = [&](int it) {
    if (it >= iters) return;
    const uint32_t raw = ring + (uint32_t)((it % kStages) * Sm::kStage) + NB * kSlabBytes;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * hf + jj;  // the s8 chunk: raw chunks j * 16 / kEpc on
      uint4 v;
      if constexpr (XT == kS8) {
        v = sm90::ld_shared_16(raw + raw_offset<XT, NB>(r, j));
      } else if constexpr (XT == kBF16) {
        v = quant_bf16x16(sm90::ld_shared_16(raw + raw_offset<XT, NB>(r, 2 * j)),
                          sm90::ld_shared_16(raw + raw_offset<XT, NB>(r, 2 * j + 1)), inv);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 f = sm90::ld_shared_16(raw + raw_offset<XT, NB>(r, 4 * j + q));
          w[q] = pack4(quant8(__uint_as_float(f.x), inv), quant8(__uint_as_float(f.y), inv),
                       quant8(__uint_as_float(f.z), inv), quant8(__uint_as_float(f.w), inv));
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      sm90::st_shared_16(qa + (uint32_t)((it & 1) * kATile) + sm90::sw64_offset(r, j), v.x, v.y,
                         v.z, v.w);
    }
  };

  // prologue: the first kAhead pairs (a group each); pair 0's A quantized
#pragma unroll 1
  for (int it = 0; it < kAhead; ++it) {
    stage_pair(it);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kAhead - 1>();
  quantize_a(0);

  int acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // every thread's s8 A of pair it is stored and its slab landed (each
    // waited for its own copies of it in pair it - 1); the barrier makes them
    // visible and says that the stage pair it - 1 read is free
    sm90::fence_proxy_async();
    __syncthreads();
    uint32_t st = ring + (uint32_t)((it % kStages) * Sm::kStage);
    uint32_t at = qa + (uint32_t)((it & 1) * kATile + wg * 64 * kKStep);
    asm volatile("" : "+r"(st), "+r"(at));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<NB>(acc, sm90::sw64_desc(at + kk * 32), sm90::sw64_desc(st + kk * 32));
    sm90::wgmma_commit();
    // pair it + kAhead into the stage pair it - 1 read; then this thread's
    // copies of pair it + 1 (the oldest group in flight) are in, and its A
    // half is quantized into the s8 tile pair it - 1 read
    stage_pair(it + kAhead);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kAhead - 1>();
    quantize_a(it + 1);
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

template <int XT, int NB>
cudaError_t launch_halo(const Args& a, cudaStream_t stream) {
  return launch(int8_conv_halo_wgmma_kernel<XT, NB>, HaloSmem<XT, NB>::kSmem, grid_of<NB>(a, 1),
                a, stream);
}

template <int XT, int NB>
cudaError_t launch_row(const Args& a, cudaStream_t stream) {
  return launch(int8_conv_row_wgmma_kernel<XT, NB>, RowSmem<XT, NB>::kSmem, grid_of<NB>(a, 0),
                a, stream);
}

template <int NB>
cudaError_t launch_nb(const Args& a, int xtype, int route, cudaStream_t stream) {
  if (route == 1) return xtype == kS8 ? launch_halo<kS8, NB>(a, stream)
                                      : launch_halo<kBF16, NB>(a, stream);
  switch (xtype) {
    case kF32: return launch_row<kF32, NB>(a, stream);
    case kBF16: return launch_row<kBF16, NB>(a, stream);
    default: return launch_row<kS8, NB>(a, stream);
  }
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC of type xtype (0 float32, 1 bfloat16: quantized
// in the kernel with the one f32 inv_act; 2 int8: already quantized,
// inv_act unused); wq (f, k, k, c) int8; deq (f,) f32; bias (f,) f32 or null;
// out (batch, ho, wo, f) of type otype (0 float32, 1 bfloat16) or null; raw
// (batch, ho, wo, f) int32 or null; ho = (h - 1) / stride + 1, the same for
// wo (padding k / 2). route 0 is the row route, 1 the halo route (k = 3,
// stride 1, xtype 1 or 2); filter_tile 64, 128 or 192; channel_step 64.
// All on the current device. Returns the CUDA error code of the launch (0 on
// success).
int nd_int8_conv(const void* x, int xtype, const void* inv_act, const void* wq, const void* deq,
                 const void* bias, void* out, int otype, void* raw, int batch, int h, int w,
                 int c, int f, int k, int stride, int route, int filter_tile, int channel_step,
                 void* stream) {
  Args a;
  const int xbytes = xtype == kF32 ? 4 : xtype == kBF16 ? 2 : 1;
  if (xtype < 0 || xtype > 2 || otype < 0 || otype > 1 || (out == nullptr && raw == nullptr) ||
      (xtype != kS8 && inv_act == nullptr) || channel_step != kKStep ||
      (route == 1 && xtype == kF32) ||
      !make_shape(a, batch, h, w, c, f, k, stride, route, filter_tile, x, xbytes, wq, 1))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.inv_act = static_cast<const float*>(inv_act);
  a.wq = static_cast<const int8_t*>(wq);
  a.deq = static_cast<const float*>(deq);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.raw = static_cast<int*>(raw);
  a.otype = otype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (filter_tile / 64) {
    case 1: return (int)launch_nb<1>(a, xtype, route, s);
    case 2: return (int)launch_nb<2>(a, xtype, route, s);
    default: return (int)launch_nb<3>(a, xtype, route, s);
  }
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
