// The Winograd F(2x2, 3x3) convolution of a bf16 forward with grad mode off
// (DiffusionModel(winograd=True)): one launch a call, the input transform,
// the 16 products on the tensor cores (wgmma, bf16 in, f32 sums) and the
// output transform fused, with an order of sums that no batch, row, batch
// mate or grid changes.
//
// Replaces no Pallas kernel. The JAX package computes
// nicediffusion_tpu/ops/winograd.py::winograd_conv_3x3 (:63) as an XLA
// composition: 4x4 tile gathers, the transforms as einsums, 16 batched
// dot_generals with f32 sums, each intermediate in device memory. Its header
// records that on a v5e this lost to the direct conv (4.8x over a forward),
// from those gathers, transposes and f32 intermediates. Here V and M never
// leave the multiprocessor.
//
// For x (B, H, W, C) NHWC bf16, u (16, F, C) bf16 (U = G g G^T of each
// filter, position p = 4 i + l, channels innermost; the wrapper makes it) and
// an optional bias (F,) f32 it computes, per 4x4 tile d of the input
// SAME-padded by one (and by zeros to even H and W) at stride 2:
//   V = B^T d B                in bf16: the rows (B^T d) rounded, then the
//                              columns rounded (ops/winograd.py, bit for bit)
//   M_p = sum_c V_p[c] U_p[c]  f32 sums (exact bf16 products)
//   Y = A^T M A                f32, rows first, each sum left to right
//   out = bf16(Y + bias)       the 2x2 outputs, those past H and W dropped
// Order of sums: every element of M sums C in 32-channel steps in ascending
// order, two k16 halves a step (one wgmma each, whose inner order is fixed);
// a block's 64 tiles are 64 independent rows of each product, and nothing
// splits C across blocks or warps. The grid (64-tile groups of all examples
// in one sequence x 32-filter tiles) follows the batch, the order does not.
//
// What bounds it. Operations: 2 * 16 * C * F per tile (4 outputs) against
// 2 (C + F) bytes a pixel: hundreds of operations a byte at the UNets'
// widths, above the card's ~295 for bf16 at 989 TFLOP/s and 3.35 TB/s, so
// the tensor cores' rate, at 4/9 of the direct conv's products. What this
// first design loses to (measured on an H100: about 7% of that bound over
// the openai_64 convs; PERF.md): (1) the staging, the most: the 16 pixel
// loads of each tile and 8 channels, the transform (32 bf16x2 additions, 16
// shared stores) and U's cp.async are made by the same threads that issue
// the products and are not hidden behind them; without them the products
// and barriers alone reach about 22%; (2) the 16 accumulators (one m64n16
// per position, 8 f32 registers each, 128 in all) bound the filters a
// warpgroup to 16, so every m64n16k16 reads a 2 KB A for a 512-byte B from
// shared memory, about 320 bytes a cycle against the ~128 it gives; (3) x
// read again for every 32 filters, U for every 64 tiles. A simple schedule,
// right first: no producer warp, no TMA, no persistent blocks.
//
// The design: a block of two warpgroups owns 64 tiles x 32 filters (each
// warpgroup 16) and walks C in 32-channel steps through two stages of
// shared memory, each V (16 positions x 64 tiles x 64 bytes, the 64-byte
// swizzle: A, K-major) and U (16 positions x 32 filters x 64 bytes: B,
// K-major). Step s: issue the 32 wgmma of stage s & 1 (A and B by
// descriptor), then stage step s + 1 into the other stage (U by cp.async,
// V by each thread's transform of one tile's 8 channels: 16 pixels loaded
// from device memory, zeros outside the map and past C), fence, wait for
// the products, block barrier. At the end each thread holds, for 4 (tile,
// filter) pairs x 2, all 16 positions in the same register of its 16
// accumulators: A^T M A in registers, the bias, one rounding, a bf16 pair
// store per output pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "conv_common.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = nd::sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;       // two warpgroups
constexpr int kTiles = 64;          // Winograd tiles a block: wgmma's M
constexpr int kFilters = 32;        // filters a block, 16 a warpgroup: wgmma's N
constexpr int kStepC = 32;          // channels a step: one 64-byte row
constexpr int kPos = 16;            // transform positions
constexpr int kVPos = kTiles * 64;  // one position's V of a step: 4096 bytes
constexpr int kUPos = kFilters * 64;  // one position's U of a step: 2048 bytes
constexpr int kV = kPos * kVPos;
constexpr int kU = kPos * kUPos;
constexpr int kStage = kV + kU;     // 96 KB
constexpr size_t kSmem = 1024 + 2 * (size_t)kStage;
static_assert(kSmem <= 232448, "over a block's shared memory");
static_assert(kThreads == kTiles * (kStepC / 8), "one thread a tile's 8 channels of a step");

struct Args {
  const bf16* x;
  const bf16* u;
  const float* bias;  // null: no bias
  bf16* out;
  int h, w, c, f;
  int th, tw;         // tile rows and columns of a map
  int steps;          // 32-channel steps
  int ftiles;         // 32-filter tiles
  long long tiles;    // batch * th * tw
  int vec_x, vec_u;   // 16-byte loads allowed (C % 8 = 0, 16-byte bases)
};

// a + b and a - b of two bf16 pairs, each rounded once to bf16 (the exact
// sum, as torch's bf16 addition gives: f32 holds the sum of two bf16 values)
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

__device__ __forceinline__ uint4 add8(const uint4& a, const uint4& b) {
  return make_uint4(badd(a.x, b.x), badd(a.y, b.y), badd(a.z, b.z), badd(a.w, b.w));
}

__device__ __forceinline__ uint4 sub8(const uint4& a, const uint4& b) {
  return make_uint4(bsub(a.x, b.x), bsub(a.y, b.y), bsub(a.z, b.z), bsub(a.w, b.w));
}

// A thread's tile in the transform: the pixel of its (row 0, column 0) over
// all examples (possibly outside the map) and which of its 4 rows and 4
// columns lie inside (none for a row past the last tile)
struct TileIn {
  long long pix0;
  uint32_t rows, cols;
};

// 8 channels from c on of tile pixel (j, k): zeros outside the map or past C
__device__ __forceinline__ uint4 load_px(const Args& a, const TileIn& t, int j, int k, int c) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!((t.rows >> j) & (t.cols >> k) & 1u) || c >= a.c) return zero;
  const bf16* p = a.x + (t.pix0 + (long long)j * a.w + k) * a.c + c;
  if (a.vec_x) return __ldg(reinterpret_cast<const uint4*>(p));
  return nd::conv::load_bytes(p, 2 * min(a.c - c, 8));
}

// row i of V from row i of B^T d (t, its 4 columns): V[i][l] = (t B)[l]
// into positions 4 i to 4 i + 3 at vst (+ off, this thread's chunk)
__device__ __forceinline__ void store_row(uint32_t vst, int i, const uint4 (&t)[4], uint32_t off) {
  const uint32_t at = vst + (uint32_t)(4 * i * kVPos) + off;
  const uint4 v0 = sub8(t[0], t[2]), v1 = add8(t[1], t[2]);
  const uint4 v2 = sub8(t[2], t[1]), v3 = sub8(t[1], t[3]);
  sm90::st_shared_16(at, v0.x, v0.y, v0.z, v0.w);
  sm90::st_shared_16(at + kVPos, v1.x, v1.y, v1.z, v1.w);
  sm90::st_shared_16(at + 2 * kVPos, v2.x, v2.y, v2.z, v2.w);
  sm90::st_shared_16(at + 3 * kVPos, v3.x, v3.y, v3.z, v3.w);
}

// V of this thread's tile and 8 channels from c on into the stage at vst.
// B^T's rows: t0 = d0 - d2, t1 = d1 + d2, t2 = -d1 + d2, t3 = d1 - d3; rows
// 1 and 2 of d first, then 0 and 3, so at most two rows of d are held (the
// 16 loads issued at once would spill)
__device__ __forceinline__ void transform(uint32_t vst, const Args& a, const TileIn& tile, int c,
                                          uint32_t off) {
  uint4 d1[4], d2[4], d[4], t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d1[k] = load_px(a, tile, 1, k, c);
    d2[k] = load_px(a, tile, 2, k, c);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = add8(d1[k], d2[k]);
  store_row(vst, 1, t, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = sub8(d2[k], d1[k]);
  store_row(vst, 2, t, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = load_px(a, tile, 0, k, c);
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = sub8(d[k], d2[k]);
  store_row(vst, 0, t, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = load_px(a, tile, 3, k, c);
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = sub8(d1[k], d[k]);
  store_row(vst, 3, t, off);
}

// U of step `step`, filters f0 to f0 + 31, into the stage at ust: 16
// positions x 32 rows x 64 bytes, 8 chunks a thread by cp.async (byte loads
// where no 16-byte copy is aligned); filters past F and channels past C as
// zeros. The caller waits and fences.
__device__ __forceinline__ void stage_u(uint32_t ust, const Args& a, int f0, int step, int tid) {
#pragma unroll
  for (int i = 0; i < kPos * kFilters * 4 / kThreads; ++i) {
    const int id = tid + kThreads * i, p = id >> 7, fr = (id >> 2) & 31, q = id & 3;
    const int fl = f0 + fr, c = step * kStepC + 8 * q;
    const int valid = fl < a.f ? min(max(a.c - c, 0), 8) : 0;
    const bf16* src = valid > 0 ? a.u + ((size_t)p * a.f + fl) * a.c + c : a.u;
    nd::conv::copy_chunk(ust + (uint32_t)(p * kUPos) + sm90::sw64_offset(fr, q), src, 2 * valid,
                         a.vec_u);
  }
}

// Y = A^T M A of one (tile, filter)'s 16 products m[4 i + l], rows first,
// each sum left to right: A^T's rows are (1, 1, 1, 0) and (0, 1, -1, -1)
__device__ __forceinline__ void output_transform(const float (&m)[16], float (&y)[2][2]) {
  float s[2][4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    s[0][l] = __fadd_rn(__fadd_rn(m[l], m[4 + l]), m[8 + l]);
    s[1][l] = __fsub_rn(__fsub_rn(m[4 + l], m[8 + l]), m[12 + l]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    y[i][0] = __fadd_rn(__fadd_rn(s[i][0], s[i][1]), s[i][2]);
    y[i][1] = __fsub_rn(__fsub_rn(s[i][1], s[i][2]), s[i][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    winograd_conv_wgmma_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const long long mt = blockIdx.x / a.ftiles;
  const int f0 = (int)(blockIdx.x - mt * a.ftiles) * kFilters;
  const long long t0 = mt * kTiles;
  const long long per = (long long)a.th * a.tw;

  // the transform's tile (row tid / 4 of the block's 64) and its 8 channels
  // (chunk tid % 4 of a step)
  const int r = tid >> 2, q = tid & 3;
  TileIn tile{0, 0u, 0u};
  if (t0 + r < a.tiles) {
    const long long b = (t0 + r) / per;
    const int rem = (int)(t0 + r - b * per), ty = rem / a.tw, tx = rem - ty * a.tw;
    const int y0 = 2 * ty - 1, x0 = 2 * tx - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (y0 + j >= 0 && y0 + j < a.h) tile.rows |= 1u << j;
      if (x0 + j >= 0 && x0 + j < a.w) tile.cols |= 1u << j;
    }
    tile.pix0 = (b * a.h + y0) * a.w + x0;
  }
  const uint32_t off = sm90::sw64_offset(r, q);

  float acc[kPos][8];
#pragma unroll
  for (int p = 0; p < kPos; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;

  stage_u(base + kV, a, f0, 0, tid);
  transform(base, a, tile, 8 * q, off);
  sm90::cp_async_commit();  // wait_group waits only for committed groups
  sm90::cp_async_wait_all();
  sm90::fence_proxy_async();
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < a.steps; ++s) {
    // the 32 products of this step: position p, k16 half kk; A = V_p (the
    // block's 64 tiles), B = U_p (this warpgroup's 16 filters), both by
    // descriptor, 8-row groups 512 bytes apart
    uint32_t vb = base + (uint32_t)((s & 1) * kStage);
    uint32_t ub = vb + (uint32_t)(kV + wg * 16 * 64);
    asm volatile("" : "+r"(vb), "+r"(ub));
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPos; ++p)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_ss_m64n16k16_bf16(acc[p], sm90::sw64_desc(vb + p * kVPos + kk * 32),
                                      sm90::sw64_desc(ub + p * kUPos + kk * 32), 1);
    sm90::wgmma_commit();
    // meanwhile the next step into the other stage, which the previous
    // step's products (waited for before the last barrier) read: U by
    // cp.async, in flight while the pixels load and V is made
    if (s + 1 < a.steps) {
      const uint32_t nx = base + (uint32_t)(((s + 1) & 1) * kStage);
      stage_u(nx + kV, a, f0, s + 1, tid);
      transform(nx, a, tile, (s + 1) * kStepC + 8 * q, off);
      sm90::cp_async_commit();
      sm90::cp_async_wait_all();
      sm90::fence_proxy_async();
    }
    sm90::wgmma_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kPos; ++p) sm90::fence_regs(acc[p]);

  // Epilogue. acc[p][4 j + 2 h + e] is position p of tile row g + 8 h of
  // the block (g = 16 warp + lane / 4), filter f0 + 16 wg + 8 j + 2 (lane %
  // 4) + e: the 16 positions of one (tile, filter) sit in one register index
  const int g = 16 * warp + lane / 4;
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long t = t0 + g + 8 * h;
    if (t >= a.tiles) continue;
    const long long b = t / per;
    const int rem = (int)(t - b * per), ty = rem / a.tw, tx = rem - ty * a.tw;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int fc = f0 + 16 * wg + 8 * j + 2 * (lane % 4);
      if (fc >= a.f) continue;
      const bool two = fc + 1 < a.f;
      float y[2][2][2];  // [e][i][l]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) m[p] = acc[p][4 * j + 2 * h + e];
        output_transform(m, y[e]);
        const float bias = a.bias != nullptr && (e == 0 || two) ? a.bias[fc + e] : 0.f;
        if (a.bias != nullptr) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int l = 0; l < 2; ++l) y[e][i][l] = __fadd_rn(y[e][i][l], bias);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int yy = 2 * ty + i, xx = 2 * tx + l;
          if (yy >= a.h || xx >= a.w) continue;
          bf16* dst = a.out + (((size_t)b * a.h + yy) * a.w + xx) * a.f + fc;
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y[0][i][l], y[1][i][l]);
          } else {
            dst[0] = __float2bfloat16_rn(y[0][i][l]);
            if (two) dst[1] = __float2bfloat16_rn(y[1][i][l]);
          }
        }
    }
  }
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC bf16; u (16, f, c) bf16; bias (f,) f32 or null;
// out (batch, h, w, f) bf16. All on the current device. Returns the CUDA
// error code of the launch (0 on success).
int nd_winograd_conv(const void* x, const void* u, const void* bias, void* out, int batch, int h,
                     int w, int c, int f, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || (long long)16 * f * c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Args a;
  std::memset(static_cast<void*>(&a), 0, sizeof(a));
  a.x = static_cast<const bf16*>(x);
  a.u = static_cast<const bf16*>(u);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.h = h, a.w = w, a.c = c, a.f = f;
  a.th = (h + 1) / 2, a.tw = (w + 1) / 2;
  a.steps = (c + kStepC - 1) / kStepC;
  a.ftiles = (f + kFilters - 1) / kFilters;
  a.tiles = (long long)batch * a.th * a.tw;
  const long long units = (a.tiles + kTiles - 1) / kTiles * a.ftiles;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  a.vec_x = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_u = c % 8 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(winograd_conv_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  winograd_conv_wgmma_kernel<<<(unsigned)units, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
