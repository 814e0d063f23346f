// K4: fused GroupNorm(+AdaGN)+SiLU feeding a stride-1 3x3 SAME convolution.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/resblock.py ::
// gn_silu_conv3x3 (body _kernel). For x (B, H, W, C) NHWC, GroupNorm affine
// gamma and beta (C,), optional AdaGN rows es and eb (B, C), a 3x3 kernel and
// a bias (F,) it computes
//   n   = (x - mean_g) * rstd_g * gamma + beta        f32, per-example groups
//   n   = n * (1 + es) + eb                           AdaGN only
//   a   = round_to_x_type(n * sigmoid(n)), zero outside the image
//   out = round_to_x_type(sum_{dy,dx,c} a[y+dy-1, x+dx-1, c] * k[dy, dx, c, :] + bias)
// with every sum in f32. The padding is zero *after* the activation, as the
// TPU kernel zero-fills its scratch and writes the interior only. The
// normalised map never goes to device memory.
//
// Design. The TPU kernel held one example's whole map in VMEM (1.5 MB at
// 64 x 64 x 192 bf16) and ran one program per example. A Hopper block has
// 227 KB of shared memory, so the work is two launches:
//   * group_stats_kernel, one block per (example, group): f32 sum and sum of
//     squares of the group's H*W*C/G elements, then mean and
//     1 / sqrt(E[x^2] - mean^2 + eps) into two (B, G) f32 scratch tensors;
//   * gn_silu_conv3x3_kernel, an implicit GEMM with one block per (8 x 8
//     output pixels, 64 filters, example), 256 threads, a 4 pixel x 4 filter
//     register tile a thread. It walks the channels 32 at a time: a warp
//     stages one pixel of the 10 x 10 halo tile a turn, its lanes along the
//     channels (so each lane keeps its channel's statistics, affine and
//     modulation in registers), normalising, modulating and activating on the
//     way into shared memory and writing literal zeros for pixels outside
//     the image; the 9 x 32 x 64 weights of the step are staged beside it
//     (16 bytes a load where F allows it).
//     Then 9 taps x 32 channels of FMAs from shared memory, read as float4
//     (four channels of a pixel, four filters of a channel).
// C/G is any integer (6 to 48 in the UNet), C any multiple of G, F, H and W
// anything: channels past C and filters past F are staged as zeros, pixels
// past the edge are computed and not stored.
// The weights come repacked as (3, 3, C, F), filters contiguous, in x's
// type; the wrapper repacks torch's (F, C, 3, 3) once and caches it.
//
// Rounding follows the TPU kernel: statistics, affine, modulation and SiLU in
// f32, the activation rounded to x's type before the products, f32 FMA sums
// (never TF32: the f32 gate is 2e-5), the bias added in f32, one rounding of
// the output.
//
// What bounds it. Operations: 2 * 9 * C * F per output pixel against
// 2 bytes * (C + F) per pixel moved, hundreds of operations a byte at the
// UNet's widths. The products run on the CUDA cores (8 FMAs per 16-byte
// shared-memory load), far below the tensor cores' bf16 rate; a wgmma/mma
// path for bf16 inputs is later work (ROADMAP queue B).

#include "attention_common.cuh"

namespace {

using nd::from_f32;
using nd::round_to;
using nd::to_f32;

constexpr int kConvThreads = 256;
constexpr int kTH = 8, kTW = 8;            // output pixels of a block
constexpr int kFT = 64;                    // filters of a block
constexpr int kKC = 32;                    // channels staged a step, one a lane
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;  // pixels of the staged input tile
constexpr size_t kConvSmem = sizeof(float) * (size_t)(kHalo * kKC + 9 * kKC * kFT);

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
group_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                   float* __restrict__ rstd, int hw, int c, int groups, float eps) {
  __shared__ float part[2][kConvThreads / 32];
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cg = c / groups;
  const T* base = x + (size_t)b * hw * c + (size_t)g * cg;
  const int total = hw * cg;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < total; i += kConvThreads) {
    const int row = i / cg, col = i - row * cg;
    const float v = to_f32(base[(size_t)row * c + col]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (threadIdx.x % 32 == 0) {
    part[0][threadIdx.x / 32] = s1;
    part[1][threadIdx.x / 32] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kConvThreads / 32; ++i) {
      s1 += part[0][i];
      s2 += part[1][i];
    }
    const float m = s1 / (float)total;
    const float var = s2 / (float)total - m * m;
    mean[blockIdx.x] = m;
    rstd[blockIdx.x] = 1.f / sqrtf(var + eps);
  }
}

// a (B, C) modulation row element, stored as f32 or as T
template <typename T>
__device__ __forceinline__ float load_emb(const void* e, size_t i, int emb_f32) {
  return emb_f32 ? static_cast<const float*>(e)[i] : to_f32(static_cast<const T*>(e)[i]);
}

struct ConvArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  const void* es;
  const void* eb;
  long long emb_stride;  // elements between two rows of es and of eb
  int emb_f32;
  const void* wt;        // (3, 3, C, F) in x's type
  const float* bias;
  const float* mean;     // (B, G)
  const float* rstd;     // (B, G)
  void* out;
  int h, w, c, f, groups, ada;
};

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
gn_silu_conv3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;               // kHalo x kKC, activated, rounded to T
  float* w_s = smem + kHalo * kKC;  // 9 x kKC x kFT

  const int h = a.h, w = a.w, c = a.c, f = a.f;
  const int tiles_x = (w + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int f0 = blockIdx.y * kFT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // this thread's outputs: pixels (py, px0 + i) of the tile, filters fq + j
  const int py = tid / 32;             // 8 rows of 8 pixels: two groups of 4 a row
  const int px0 = ((tid / 16) % 2) * 4;
  const int fq = (tid % 16) * 4;
  const int cg = c / a.groups;
  const T* xb = static_cast<const T*>(a.x) + (size_t)b * h * w * c;
  const T* wt = static_cast<const T*>(a.wt);
  // whole 16-byte vectors of a weight row lie inside F and are aligned
  const bool vec_ok = f % (16 / (int)sizeof(T)) == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < c; c0 += kKC) {
    // the 9 x 32 products of a step are summed apart and then added to the
    // total: two short sums lose less than one of 9 * C terms (13,824 at
    // C = 1536, where a single f32 sum would eat most of the 2e-5 gate)
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    __syncthreads();  // the previous step's readers are done with in_s and w_s
    {
      const int ch = c0 + lane;
      const bool ch_ok = ch < c;
      float mu = 0.f, rs = 0.f, ga = 0.f, be = 0.f, sc = 1.f, sh = 0.f;
      if (ch_ok) {
        const int g = ch / cg;
        mu = a.mean[b * a.groups + g];
        rs = a.rstd[b * a.groups + g];
        ga = a.gamma[ch];
        be = a.beta[ch];
        if (a.ada) {
          const size_t e = (size_t)b * a.emb_stride + ch;
          sc = 1.f + load_emb<T>(a.es, e, a.emb_f32);
          sh = load_emb<T>(a.eb, e, a.emb_f32);
        }
      }
#pragma unroll 4
      for (int p = warp; p < kHalo; p += kConvThreads / 32) {
        const int yy = y0 + p / kHaloW - 1, xx = x0 + p % kHaloW - 1;
        float v = 0.f;  // outside the image: zero after the activation
        if (ch_ok && yy >= 0 && yy < h && xx >= 0 && xx < w) {
          float n = (to_f32(xb[((size_t)yy * w + xx) * c + ch]) - mu) * rs;
          n = n * ga + be;
          if (a.ada) n = n * sc + sh;
          n = n * (1.f / (1.f + expf(-n)));
          v = round_to<T>(n);
        }
        in_s[p * kKC + lane] = v;
      }
    }
    if (vec_ok) {
      // 16 bytes a load: kVec filters of one (tap, channel) row
      constexpr int kVec = 16 / sizeof(T);
      constexpr int kRow = kFT / kVec;
#pragma unroll 3
      for (int i = tid; i < 9 * kKC * kRow; i += kConvThreads) {
        const int ff = (i % kRow) * kVec, cc = (i / kRow) % kKC, tap = i / (kRow * kKC);
        const int ch = c0 + cc, fo = f0 + ff;
        float vals[kVec];
        if (ch < c && fo < f) {
          const uint4 raw = *reinterpret_cast<const uint4*>(wt + ((size_t)tap * c + ch) * f + fo);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int k = 0; k < kVec; ++k) vals[k] = to_f32(v[k]);
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) vals[k] = 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(w_s + (tap * kKC + cc) * kFT + ff);
#pragma unroll
        for (int k = 0; k < kVec / 4; ++k)
          dst[k] = make_float4(vals[4 * k], vals[4 * k + 1], vals[4 * k + 2], vals[4 * k + 3]);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < 9 * kKC * kFT; i += kConvThreads) {
        const int ff = i % kFT, cc = (i / kFT) % kKC, tap = i / (kFT * kKC);
        const int ch = c0 + cc, fo = f0 + ff;
        w_s[i] = (ch < c && fo < f) ? to_f32(wt[((size_t)tap * c + ch) * f + fo]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* ib = in_s + ((py + dy) * kHaloW + px0 + dx) * kKC;
      const float* wb = w_s + tap * kKC * kFT + fq;
#pragma unroll 2
      for (int cc = 0; cc < kKC; cc += 4) {
        float4 av[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(ib + i * kKC + cc);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = *reinterpret_cast<const float4*>(wb + (cc + k) * kFT);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            part[i][0] = fmaf(ak[k], wv[k].x, part[i][0]);
            part[i][1] = fmaf(ak[k], wv[k].y, part[i][1]);
            part[i][2] = fmaf(ak[k], wv[k].z, part[i][2]);
            part[i][3] = fmaf(ak[k], wv[k].w, part[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

  const int yy = y0 + py;
  if (yy >= h) return;
  T* ob = static_cast<T*>(a.out) + ((size_t)b * h + yy) * w * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = x0 + px0 + i;
    if (xx >= w) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fo = f0 + fq + j;
      if (fo < f) ob[(size_t)xx * f + fo] = from_f32<T>(acc[i][j] + a.bias[fo]);
    }
  }
}

template <typename T>
cudaError_t launch(const ConvArgs& a, int batch, float* mean, float* rstd, float eps,
                   cudaStream_t stream) {
  group_stats_kernel<T><<<batch * a.groups, kConvThreads, 0, stream>>>(
      static_cast<const T*>(a.x), mean, rstd, a.h * a.w, a.c, a.groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = gn_silu_conv3x3_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kConvSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.h + kTH - 1) / kTH) * ((a.w + kTW - 1) / kTW);
  dim3 grid(tiles, (a.f + kFT - 1) / kFT, batch);
  kernel<<<grid, kConvThreads, kConvSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of x, wt and out. x is
// (batch, h, w, c) and out (batch, h, w, f), NHWC; wt is (3, 3, c, f); gamma,
// beta (c,) and bias (f,) are f32; es and eb are rows of c elements
// emb_stride apart, f32 if emb_f32 else of x's type, read only if ada; mean
// and rstd are f32 (batch, groups) scratch. All on the current device.
// Returns the CUDA error code of the launches (0 on success).
int nd_gn_silu_conv3x3(const void* x, const void* gamma, const void* beta, const void* es,
                       const void* eb, long long emb_stride, int emb_f32, const void* wt,
                       const void* bias, void* out, void* mean, void* rstd, int batch, int h,
                       int w, int c, int f, int groups, float eps, int ada, int dtype,
                       void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || f <= 0 || groups <= 0 || c <= 0 || c % groups != 0 ||
      batch > 65535 || (f + kFT - 1) / kFT > 65535)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.es = es;
  a.eb = eb;
  a.emb_stride = emb_stride;
  a.emb_f32 = emb_f32;
  a.wt = wt;
  a.bias = static_cast<const float*>(bias);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.out = out;
  a.h = h;
  a.w = w;
  a.c = c;
  a.f = f;
  a.groups = groups;
  a.ada = ada;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean_f = static_cast<float*>(mean);
  float* rstd_f = static_cast<float*>(rstd);
  if (dtype == 0) return (int)launch<float>(a, batch, mean_f, rstd_f, eps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, batch, mean_f, rstd_f, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
