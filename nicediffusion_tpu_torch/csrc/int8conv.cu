// The int8 convolution of static int8 serving: s8 x s8 -> s32 on the tensor
// cores (wgmma), the activation quantized by a launch before it and the
// dequantization in its epilogue.
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
// round-half-to-even, jnp.round's rule. The sums are exact; the f32 product
// and sum of the epilogue are each rounded once (no FMA contraction), as XLA
// rounds them. An optional raw output receives the s32 sums themselves.
//
// What bounds it. Operations: 2 k^2 C F per output pixel against (C + F)
// bytes of int8 per pixel, hundreds to thousands of operations a byte at the
// UNets' widths, above the card's ~590 for int8 at 1,979 TOPS and 3.35 TB/s:
// the tensor cores' int8 rate, twice the bf16 one.
//
// Design.
//   * quantize_kernel: x_q = clip(rint(x * inv_act)) into an s8 scratch
//     tensor, 16 elements a thread and turn (one 16-byte store). A float x
//     costs this one extra pass over it (read 2 or 4 bytes, write 1 an
//     element); in exchange the conv stages A by cp.async like B. XLA fuses
//     the quantize into the GroupNorm before each conv; doing the same in
//     K3's epilogue would remove the pass (ROADMAP queue B).
//   * The conv is an implicit GEMM: M is output pixels, all examples in one
//     sequence (B * Ho * Wo rows: a tile may span two examples), N filters, K
//     the k^2 taps x C channels, walked 128 channels (one 128-byte row a
//     pixel) at a time. A block is two warpgroups (256 threads) and owns 128
//     pixels (64 a warpgroup: one wgmma row block) x 128 filters.
//   * 8-bit wgmma takes only K-major A and B. So the weights are frozen as
//     (F, k, k, C), channels innermost per filter: a (tap, channel step)
//     slab is 128 filters x 128 bytes. The A tile is 128 im2col rows, each
//     pixel's 128 channels of the tap's shifted input. Both are staged by
//     16-byte cp.async into the 128-byte swizzle (byte loads where C is no
//     multiple of 16) and read by descriptor. Channels past C, filters past
//     F, pixels past the map or the last row are zeros (cp.async zero
//     fill); C, F, H and W are anything.
//   * A ring of 3 (tap, step) stages: two pairs load while one is
//     multiplied. 96 KB of ring and at most 128 registers a thread (64 s32
//     sums) let two blocks share a multiprocessor, so one block's barrier
//     and epilogue overlap the other's products.
//   * Every product is wgmma m64n128k32 (s8 in, s32 sums), four a step. A
//     step's last 32-channel groups past C are multiplied as zeros (C of
//     192 costs two full steps); skipping them would put wgmma under control
//     flow the compiler may serialise.
//   * Epilogue through shared memory (the ring is free by then): the s32
//     tile, then rows written by consecutive threads, float(s) * deq plus
//     the bias, one rounding to the output type; the raw sums if asked for.
//     Holding the 32 columns' deq and bias in registers instead cost the
//     bf16 instance a spill under the 128-register cap.
// Each A element is read once per tap (k^2 times for a 3 x 3 conv, mostly
// from L2); a halo tile as in resblock.cu would read it once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace {

namespace sm90 = nd::sm90;

constexpr int kThreads = 256;           // two warpgroups
constexpr int kBM = 128;                // output pixels a block, 64 a warpgroup
constexpr int kBN = 128;                // filters a block
constexpr int kBK = 128;                // channels a step: one 128-byte row
constexpr int kTileBytes = 128 * 128;   // the A or the B tile of a stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kStages = 3;              // the cp.async ring
constexpr size_t kSmem = kStages * kStageBytes + 1024;
constexpr int kLd = kBN + 8;            // row stride of the epilogue's s32 tile, in words
static_assert(kBM * kLd * 4 <= kStages * kStageBytes, "the epilogue tile fits in the ring");
constexpr uint32_t kSbo = 8 * 128;      // 8 rows of 128 bytes: one swizzle atom
constexpr int kChunks = kBM * 8 / kThreads;  // 16-byte chunks of A (and of B) a thread stages
constexpr int kQuantThreads = 256;

enum { kF32 = 0, kBF16 = 1, kS8 = 2 };

struct Args {
  const int8_t* x;  // the quantized input
  const int8_t* wq;
  const float* deq;
  const float* bias;  // null: no bias
  void* out;          // null: no dequantized output
  int* raw;           // null: no raw sums
  int h, w, c, f, k, stride, pad, ho, wo, taps, steps;
  long long m;  // output pixels, batch * ho * wo
  int vec_x, vec_w;
};

// the input pixel a staged A row reads at tap (0, 0), and whether the row is
// an output pixel at all
struct Row {
  int img, iy, ix;
  bool live;
};

__device__ __forceinline__ int quant8(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// 16 consecutive elements from a 16-byte-aligned address, as floats
__device__ __forceinline__ void load16(float (&f)[16], const float* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
    f[4 * q] = t.x, f[4 * q + 1] = t.y, f[4 * q + 2] = t.z, f[4 * q + 3] = t.w;
  }
}

__device__ __forceinline__ void load16(float (&f)[16], const __nv_bfloat16* p) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const uint32_t wds[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[8 * q + 2 * i] = sm90::bf16_lo(wds[i]);
      f[8 * q + 2 * i + 1] = sm90::bf16_hi(wds[i]);
    }
  }
}

// x_q = clip(rint(x * inv_act), -127, 127) over n elements; vec: 16 elements
// a thread and turn from 16-byte-aligned x and x_q (n a multiple of 16)
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_kernel(const T* __restrict__ x,
                                                                 const float* __restrict__ inv_act,
                                                                 int8_t* __restrict__ xq,
                                                                 long long n, int vec) {
  const float inv = __ldg(inv_act);
  const long long step = (long long)gridDim.x * kQuantThreads;
  long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  if (vec) {
    for (; i < n / 16; i += step) {
      float f[16];
      load16(f, x + 16 * i);
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j / 4] |= ((uint32_t)quant8(f[j], inv) & 0xFFu) << (8 * (j % 4));
      *reinterpret_cast<uint4*>(xq + 16 * i) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  for (; i < n; i += step) xq[i] = (int8_t)quant8(load_f32(x + i), inv);
}

// n (1 to 16) bytes from p, packed in four words, the rest zero
__device__ __forceinline__ void load_bytes(uint32_t (&v)[4], const int8_t* p, int n) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) v[j / 4] |= ((uint32_t)(uint8_t)p[j]) << (8 * (j % 4));
}

// the A tile of (tap, channels c0 on): row r is output pixel m0 + r, its 128
// channels of the tap's input pixel, zeros outside the map; by cp.async
// where every chunk is whole and aligned (the caller commits), else by byte
// loads
__device__ __forceinline__ void stage_a(uint32_t dst, const Args& a, const Row (&rows)[kChunks],
                                        int tap, int c0, int tid) {
  const int dy = tap / a.k, dx = tap - dy * a.k;
  const int chunk = tid & 7, c = c0 + chunk * 16;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int r = (tid >> 3) + 32 * i;
    const uint32_t at = dst + sm90::sw128_offset(r, chunk, kBM);
    const int iy = rows[i].iy + dy, ix = rows[i].ix + dx;
    const bool in = rows[i].live && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w && c < a.c;
    const int8_t* p = in ? a.x + ((((long long)rows[i].img * a.h + iy) * a.w + ix) * a.c + c) : a.x;
    if (a.vec_x) {
      sm90::cp_async_16(at, p, in ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (in) load_bytes(v, p, min(a.c - c, 16));
      sm90::st_shared_16(at, v[0], v[1], v[2], v[3]);
    }
  }
}

// the B tile of (tap, channels c0 on): row r is filter f0 + r, its 128
// channels at the tap, the same two ways
__device__ __forceinline__ void stage_b(uint32_t dst, const Args& a, int f0, int tap, int c0,
                                        int tid) {
  const int chunk = tid & 7, c = c0 + chunk * 16;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int r = (tid >> 3) + 32 * i, fl = f0 + r;
    const uint32_t at = dst + sm90::sw128_offset(r, chunk, kBN);
    const bool in = fl < a.f && c < a.c;
    const int8_t* p = in ? a.wq + (((long long)fl * a.taps + tap) * a.c + c) : a.wq;
    if (a.vec_w) {
      sm90::cp_async_16(at, p, in ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (in) load_bytes(v, p, min(a.c - c, 16));
      sm90::st_shared_16(at, v[0], v[1], v[2], v[3]);
    }
  }
}

// (tap, channel step) pair it into ring stage it % kStages
__device__ __forceinline__ void stage_pair(uint32_t base, const Args& a, const Row (&rows)[kChunks],
                                           int f0, int it, int tid) {
  const int tap = it / a.steps, c0 = (it - tap * a.steps) * kBK;
  const uint32_t st = base + (uint32_t)((it % kStages) * kStageBytes);
  stage_b(st + kTileBytes, a, f0, tap, c0, tid);
  stage_a(st, a, rows, tap, c0, tid);
}

template <int OT>
__device__ __forceinline__ void store_out(const Args& a, size_t o, int f, int s) {
  float v = __fmul_rn(__int2float_rn(s), a.deq[f]);
  if (a.bias != nullptr) v = __fadd_rn(v, a.bias[f]);
  if (OT == kF32)
    static_cast<float*>(a.out)[o] = v;
  else
    static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
}

template <int OT>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_wgmma_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;

  Row rows[kChunks];
  const long long per_img = (long long)a.ho * a.wo;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const long long m = m0 + (tid >> 3) + 32 * i;
    rows[i].live = m < a.m;
    const long long mm = rows[i].live ? m : 0;
    const long long img = mm / per_img;
    const int rem = (int)(mm - img * per_img), oy = rem / a.wo, ox = rem - oy * a.wo;
    rows[i].img = (int)img;
    rows[i].iy = oy * a.stride - a.pad;
    rows[i].ix = ox * a.stride - a.pad;
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // (tap, channel step) pairs, steps fastest; the first kStages - 1 in flight
  // before the loop, one commit group each (empty past the last pair)
  const int iters = a.taps * a.steps;
#pragma unroll 1
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < iters) stage_pair(base, a, rows, f0, it, tid);
    sm90::cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // pair it landed (this thread's copies; its stores are done); the barrier
    // makes everyone's visible and says that both warpgroups waited for the
    // products of pair it - 1, whose stage the loads below overwrite
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    uint32_t st = base + (uint32_t)((it % kStages) * kStageBytes);
    asm volatile("" : "+r"(st));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_m64n128k32_s8(
          acc, sm90::sw128_desc(st + wg * 64 * 128 + kk * 32, 16, kSbo),
          sm90::sw128_desc(st + kTileBytes + kk * 32, 16, kSbo), 1);
    sm90::wgmma_commit();
    if (it + kStages - 1 < iters) stage_pair(base, a, rows, f0, it + kStages - 1, tid);
    sm90::cp_async_commit();
    sm90::wgmma_wait<0>();
  }
  sm90::fence_regs(acc);

  // Epilogue through shared memory, free once both warpgroups are past their
  // last products: the 128 x 128 s32 tile, then rows of it written out by
  // consecutive threads (coalesced stores, and no per-thread column
  // constants held in registers). acc[4j + 2 half + e] is warpgroup row
  // 16 warp + lane / 4 + 8 half, filter 8j + 2 (lane % 4) + e of the block's 128.
  __syncthreads();
  int* tile = reinterpret_cast<int*>(smem_raw + (base - sm90::smem_addr(smem_raw)));
  const int row = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(row + 8 * half) * kLd + 8 * j + 2 * (lane % 4) + e] = acc[4 * j + 2 * half + e];
  __syncthreads();
#pragma unroll 4
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, col = idx % kBN;
    const long long m = m0 + r;
    const int f = f0 + col;
    if (m >= a.m || f >= a.f) continue;
    const int s = tile[r * kLd + col];
    const size_t o = (size_t)m * a.f + f;
    if (a.raw != nullptr) a.raw[o] = s;
    if (a.out != nullptr) store_out<OT>(a, o, f, s);
  }
}

template <int OT>
cudaError_t launch_conv(const Args& a, cudaStream_t stream) {
  auto kernel = int8_conv_wgmma_kernel<OT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.m + kBM - 1) / kBM), (unsigned)((a.f + kBN - 1) / kBN));
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quantize(const void* x, const void* inv_act, int8_t* xq, long long n,
                            cudaStream_t stream) {
  const int vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  const long long work = vec ? n / 16 : n;
  const long long blocks = (work + kQuantThreads - 1) / kQuantThreads;
  quantize_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv_act), xq, n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC of type xtype (0 float32, 1 bfloat16: quantized
// first by a launch of its own into xq, (batch, h, w, c) int8 scratch, with
// the one f32 inv_act; 2 int8: already quantized, inv_act and xq unused);
// wq (f, k, k, c) int8; deq (f,) f32; bias (f,) f32 or null; out
// (batch, ho, wo, f) of type otype (0 float32, 1 bfloat16) or null; raw
// (batch, ho, wo, f) int32 or null; ho = (h - 1) / stride + 1, the same for
// wo (padding k / 2). All on the current device. Returns the CUDA error code
// of the launches (0 on success).
int nd_int8_conv(const void* x, int xtype, const void* inv_act, void* xq, const void* wq,
                 const void* deq, const void* bias, void* out, int otype, void* raw, int batch,
                 int h, int w, int c, int f, int k, int stride, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || xtype < 0 || xtype > 2 || otype < 0 || otype > 1 ||
      (out == nullptr && raw == nullptr) ||
      (xtype != kS8 && (inv_act == nullptr || xq == nullptr)) || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.wq = static_cast<const int8_t*>(wq);
  a.deq = static_cast<const float*>(deq);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.raw = static_cast<int*>(raw);
  a.h = h, a.w = w, a.c = c, a.f = f, a.k = k, a.stride = stride, a.pad = k / 2;
  a.ho = (h + 2 * a.pad - k) / stride + 1;
  a.wo = (w + 2 * a.pad - k) / stride + 1;
  a.taps = k * k;
  a.steps = (c + kBK - 1) / kBK;
  a.m = (long long)batch * a.ho * a.wo;
  if ((a.m + kBM - 1) / kBM > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)batch * h * w * c;
  cudaError_t err = cudaSuccess;
  if (xtype == kF32) err = launch_quantize<float>(x, inv_act, static_cast<int8_t*>(xq), n, s);
  if (xtype == kBF16)
    err = launch_quantize<__nv_bfloat16>(x, inv_act, static_cast<int8_t*>(xq), n, s);
  if (err != cudaSuccess) return (int)err;
  a.x = static_cast<const int8_t*>(xtype == kS8 ? x : xq);
  a.vec_x = c % 16 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.vec_w = c % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  return (int)(otype == kF32 ? launch_conv<kF32>(a, s) : launch_conv<kBF16>(a, s));
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
