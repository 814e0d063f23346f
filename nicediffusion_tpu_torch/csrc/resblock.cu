// K4: fused GroupNorm(+AdaGN)+SiLU feeding a stride-1 3x3 SAME convolution.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/resblock.py ::
// gn_silu_conv3x3 (body _kernel, pallas_call in _fused_call). For x
// (B, H, W, C) NHWC, GroupNorm affine gamma and beta (C,), optional AdaGN rows
// es and eb (B, C), a 3x3 kernel and a bias (F,) it computes
//   n   = (x - mean_g) * rstd_g * gamma + beta        f32, per-example groups
//   n   = n * (1 + es) + eb                           AdaGN only
//   a   = round_to_x_type(n * sigmoid(n)), zero outside the image
//   out = round_to_x_type(sum_{dy,dx,c} a[y+dy-1, x+dx-1, c] * k[dy, dx, c, :] + bias)
// with every sum in f32. The padding is zero *after* the activation, as the
// TPU kernel zero-fills its scratch and writes the interior only. The
// normalised map never goes to device memory.
//
// The TPU kernel held one example's whole map in VMEM (1.5 MB at
// 64 x 64 x 192 bf16) and ran one program per example. A Hopper block has
// 227 KB of shared memory, so the work is two launches: the group statistics,
// then an implicit GEMM that normalises its input tile on the way in.
// The weights come repacked as (3, 3, C, F), filters contiguous, in x's
// type; the wrapper repacks torch's (F, C, 3, 3) once and caches it.
// C/G is any integer (6 to 64 in the UNets), C any multiple of G, F, H and W
// anything: channels past C and filters past F are staged as zeros, pixels
// past the edge are computed and not stored.
//
// What bounds it. Operations: 2 * 9 * C * F per output pixel against
// 2 bytes * (C + F) per pixel moved, 860 to 6,100 operations a byte at the
// UNets' widths, far above the card's 295 for bf16: the tensor cores' rate.
//
// group_stats_kernel, one block per (example, group): f32 sum and sum of
// squares of the group's H*W*C/G elements, then mean and
// 1 / sqrt(E[x^2] - mean^2 + eps) into two (B, G) f32 scratch tensors. For
// the bf16 kernel it also folds statistics, affine and modulation into one
// pair per (example, channel), n = x * A + B, in an f32 (B, Cpad, 2) scratch
// (Cpad = C rounded up to 64, the pairs past C zero).
//
// bf16: the tensor cores (gn_silu_conv3x3_wgmma_kernel). An implicit GEMM:
// M is output pixels, N filters, K the 9 taps x C channels, walked 64
// channels (one 128-byte row a pixel) at a time.
//   * A block is two warpgroups (256 threads). Each owns one 8 x 8 tile of
//     output pixels (M = 64: one wgmma row block) and its own 10 x 10 halo;
//     the two share N = 64 * NB filters (NB = 1, 2 or 3). The tiles of all
//     examples are numbered in one sequence, so at the 8 x 8 maps the two
//     warpgroups of a block may serve two examples.
//   * A (the activations) comes from registers. The halo of a channel step
//     lands raw by 16-byte cp.async (its 64 (A, B) pairs beside it), is
//     normalised, modulated and activated in place in f32, rounded to bf16
//     (the TPU kernel's rounding point), with literal zeros outside the
//     image. A pixel is a 128-byte row whose 16-byte chunk c lies at chunk
//     c ^ (pixel % 8), so the eight pixels of an ldmatrix 8 x 8 read fall on
//     eight bank groups. A tap (dy, dx) is the halo shifted by (dy, dx): its
//     64 x 16 A fragments are four ldmatrix.x4 a thread straight into the
//     wgmma register layout (sm90.cuh). A shifted window is no
//     swizzle-atom-aligned descriptor operand, which is why A is not read
//     by descriptor.
//   * B (the weights) is read by descriptor, MN-major as it lies: for one
//     (tap, 64-channel step) the (3, 3, C, F) weights are a 64 x N slab,
//     staged by 16-byte cp.async into the 128-byte swizzle, in a ring of 4
//     stages over the 9 * ceil(C / 64) (tap, step) pairs: two slabs load
//     while one is multiplied. A thread computes the offsets of its 2 NB
//     chunks of a slab once; a ragged slab (C not a multiple of 64, filters
//     past F, F not a multiple of 8) goes through stage_tile, which masks
//     and takes 2-byte loads (its per-chunk address arithmetic at every tap
//     slowed the whole kernel measurably).
//   * Every product is wgmma m64n64k16 (bf16 in, f32 sums), NB a k16 step.
//     A tap's products run while the thread starts later loads and does one
//     normalisation task, then it waits for them: keeping one group in
//     flight across the barrier measured no faster, and at NB = 1 ptxas
//     serialised it. One m64n128k16 or m64n192k16 in place of NB m64n64k16
//     measured no faster either.
//   * Overlap: three halo buffers rotate (multiplied, being normalised,
//     landing). While step s multiplies, each thread normalises its seven
//     (pixel, chunk) tasks of step s + 1, one after each tap's products
//     start, and the raw halo of step s + 2 loads.
//   * Epilogue: f32 sums plus the f32 bias, one rounding to bf16, stored as
//     bf16 pairs (16 contiguous bytes a quad of lanes).
//   * NB is chosen per call (pick_nb): the width whose waves over the card's
//     multiprocessors cost least, counting a block as its filters plus 64
//     for its halo work. At (16, 8, 8, 768) there are 8 blocks of 2 tiles:
//     NB = 1 gives 96 blocks; at (16, 16, 16, 576) NB = 3 gives 96; from the
//     32 x 32 maps up, NB = 3 (openai_64, F a multiple of 192) or 2
//     (openai_128) and several waves.
//   * Shared memory: 4 * 8 KB * NB of ring + 3 * 2 * 12,800 of halo +
//     3 * 2 * 512 of (A, B) pairs + 1 KB of alignment: 113,664 / 146,432 /
//     179,200 bytes at NB = 1 / 2 / 3: two blocks a multiprocessor at NB =
//     1, one at NB = 2 and 3.
//     Registers a thread: NB * 32 of sums, 16 of fragments, 4 NB of slab
//     offsets; ptxas (CUDA 12.8) gives 167 / 145 / 95 at NB = 3 / 2 / 1, no
//     spill.
//   * SiLU is n / (1 + 2^(-n log2 e)) with ex2.approx and a fast divide
//     (relative error about 2^-21, before the rounding to bf16).
//
// f32: the CUDA cores (gn_silu_conv3x3_kernel), unchanged since it was
// written: the f32 gate is 2e-5, which rules out TF32 and bf16 products. One
// block per (8 x 8 output pixels, 64 filters, example), 256 threads, a 4
// pixel x 4 filter register tile a thread. It walks the channels 32 at a
// time: a warp stages one pixel of the 10 x 10 halo tile a turn, its lanes
// along the channels, normalising on the way into shared memory; the
// 9 x 32 x 64 weights of the step are staged beside it. Then 9 taps x 32
// channels of FMAs from shared memory, read as float4. Statistics, affine,
// modulation and SiLU in f32, the activation rounded to x's type, f32 FMA
// sums, the bias in f32, one rounding of the output.

#include "attention_common.cuh"
#include "sm90.cuh"

#include <climits>

namespace {

namespace sm90 = nd::sm90;
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
  // the bf16 kernel only
  const float* ab;       // (B, cpad, 2): n = x * A + B per (example, channel)
  int cpad;              // C rounded up to a whole channel step
  int tiles;             // 8 x 8 output tiles over all examples
  int vec_x, vec_w;      // x and the weights allow 16-byte loads
};

// a (B, C) modulation row element, stored as f32 or as T
template <typename T>
__device__ __forceinline__ float load_emb(const void* e, size_t i, int emb_f32) {
  return emb_f32 ? static_cast<const float*>(e)[i] : to_f32(static_cast<const T*>(e)[i]);
}

// the group statistics; with ab, also the (A, B) pair of each of the group's
// channels (and zeros for the channels past C, written by group 0)
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
group_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                   float* __restrict__ rstd, int hw, int c, int groups, float eps,
                   const ConvArgs a, float* __restrict__ ab) {
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
    part[0][0] = m;
    part[1][0] = rstd[blockIdx.x];
  }
  if (ab == nullptr) return;
  __syncthreads();
  const float m = part[0][0], rs = part[1][0];
  float2* row = reinterpret_cast<float2*>(ab) + (size_t)b * a.cpad;
  for (int t = threadIdx.x; t < cg; t += kConvThreads) {
    const int ch = g * cg + t;
    float sc = 1.f, sh = 0.f;
    if (a.ada) {
      const size_t e = (size_t)b * a.emb_stride + ch;
      sc = 1.f + load_emb<T>(a.es, e, a.emb_f32);
      sh = load_emb<T>(a.eb, e, a.emb_f32);
    }
    const float k = rs * a.gamma[ch];
    row[ch] = make_float2(k * sc, (a.beta[ch] - m * k) * sc + sh);
  }
  if (g == 0)
    for (int ch = c + threadIdx.x; ch < a.cpad; ch += kConvThreads)
      row[ch] = make_float2(0.f, 0.f);
}

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

// ------------------------------------------------------- bf16, tensor cores

constexpr int kWgThreads = 128;                  // one warpgroup: one 8 x 8 output tile
constexpr int kWgs = 2;                          // warpgroups a block, sharing the weight ring
constexpr int kWgBlockThreads = kWgs * kWgThreads;
constexpr int kSide = 8;                         // output tile side
constexpr int kHSide = kSide + 2;                // halo side
constexpr int kHPx = kHSide * kHSide;            // halo pixels
constexpr int kKStep = 64;                       // channels a step: a 128-byte row a pixel
constexpr int kHaloBytes = kHPx * 128;
constexpr int kPairBytes = kKStep * 8;           // the step's (A, B) pairs, f32
constexpr int kBufs = 3;                         // halo buffers: multiplied, normalised, landing
constexpr int kStages = 4;                       // weight ring
constexpr int kTasks = (kHPx * 8 + kWgThreads - 1) / kWgThreads;  // (pixel, chunk) tasks a thread
constexpr uint32_t kSbo = 8 * 128;               // 8 rows of 128 bytes: one swizzle atom
static_assert(kTasks <= 9, "a step's normalisation runs one task after each tap");

template <int NB>
struct ConvTile {
  static constexpr int kStageBytes = kKStep * 128 * NB;  // 64 channels x 64 NB filters
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kHalos = kBufs * kWgs * kHaloBytes;
  static constexpr int kPairs = kBufs * kWgs * kPairBytes;
  static constexpr size_t kSmem = kRing + kHalos + kPairs + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// byte offset of the 16-byte chunk `chunk` (channels 8 chunk to 8 chunk + 7)
// of halo pixel p
__device__ __forceinline__ uint32_t halo_offset(int p, int chunk) {
  return (uint32_t)(p * 128 + ((chunk ^ (p & 7)) << 4));
}

// a warpgroup's 8 x 8 output tile: example, top-left pixel, and whether it
// exists (a block's second warpgroup past the last tile computes the last
// tile again and stores nothing)
struct Tile8 {
  int b, y0, x0;
  bool live;
};

__device__ __forceinline__ Tile8 tile_of(int s, const ConvArgs& a) {
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

__device__ __forceinline__ bool outside(const Tile8& t, const ConvArgs& a, int p) {
  const int yy = t.y0 + p / kHSide - 1, xx = t.x0 + p % kHSide - 1;
  return yy < 0 || yy >= a.h || xx < 0 || xx >= a.w;
}

// The raw halo of channel step `step` (x as it lies, zeros past C) into a
// warpgroup's halo buffer, and the step's (A, B) pairs beside it; pixels
// outside the image are left alone (normalise writes zeros there). Task id
// is (pixel id / 8, chunk id % 8): a thread stages the chunks it normalises.
__device__ __forceinline__ void stage_halo(uint32_t halo, uint32_t pairs, const ConvArgs& a,
                                           const Tile8& t, int step, int tid) {
  using bf16 = __nv_bfloat16;
  const bf16* xb = static_cast<const bf16*>(a.x) + (size_t)t.b * a.h * a.w * a.c;
#pragma unroll 1
  for (int id = tid; id < kHPx * 8; id += kWgThreads) {
    const int p = id >> 3, chunk = id & 7;
    if (outside(t, a, p)) continue;
    const int yy = t.y0 + p / kHSide - 1, xx = t.x0 + p % kHSide - 1;
    const int ch = step * kKStep + chunk * 8;
    const int valid = min(max(a.c - ch, 0), 8);  // channels from memory
    const uint32_t at = halo + halo_offset(p, chunk);
    // with no channel to read, an aligned address that is not read
    const bf16* src = valid > 0 ? xb + ((size_t)yy * a.w + xx) * a.c + ch : xb;
    if (a.vec_x) {
      sm90::cp_async_16(at, src, 2 * valid);
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < valid) v[j / 2] |= (uint32_t)e[j] << (16 * (j % 2));
      sm90::st_shared_16(at, v[0], v[1], v[2], v[3]);
    }
  }
  if (tid < kPairBytes / 16)
    sm90::cp_async_16(pairs + tid * 16,
                      a.ab + ((size_t)t.b * a.cpad + (size_t)step * kKStep) * 2 + tid * 4, 16);
}

__device__ __forceinline__ float silu(float n) {
  return __fdividef(n, 1.f + sm90::ex2(-1.4426950408889634f * n));
}

// one (pixel, chunk) task: the staged raw values normalised, modulated and
// activated in place (n = x A + B, SiLU, rounded to bf16); zeros outside the
// image
__device__ __forceinline__ void normalise(uint32_t halo, uint32_t pairs, const ConvArgs& a,
                                          const Tile8& t, int p, int chunk) {
  const uint32_t at = halo + halo_offset(p, chunk);
  if (outside(t, a, p)) {
    sm90::st_shared_16(at, 0u, 0u, 0u, 0u);
    return;
  }
  const uint4 raw = sm90::ld_shared_16(at);
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t act[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // A and B of channels 8 chunk + 2i and 8 chunk + 2i + 1
    const uint4 q = sm90::ld_shared_16(pairs + chunk * 64 + i * 16);
    const float n0 = fmaf(sm90::bf16_lo(in[i]), __uint_as_float(q.x), __uint_as_float(q.y));
    const float n1 = fmaf(sm90::bf16_hi(in[i]), __uint_as_float(q.z), __uint_as_float(q.w));
    act[i] = sm90::pack_bf16x2(silu(n0), silu(n1));
  }
  sm90::st_shared_16(at, act[0], act[1], act[2], act[3]);
}

// what every (step, tap) pair of a warpgroup needs
template <int NB>
struct WgState {
  // the 16-byte chunks of a whole weight slab this thread copies: offset in
  // the ring stage and elements into the slab
  uint32_t w_smem[2 * NB], w_gmem[2 * NB];
  bool w_whole;  // whole slabs: C a multiple of 64, this block's filters all inside F
  uint32_t ring, halo0, pairs0;  // the ring, buffer 0 of this warpgroup's halo and pairs
  const __nv_bfloat16* wt;       // the weights from this block's first filter
  Tile8 t;
  int f0, steps, iters, tid, wtid;
  // this lane's ldmatrix row: matrix j = lane / 8 holds rows 8 (j % 2) to
  // 8 (j % 2) + 7 of the warp's 16 (tile row 2 warp + j % 2, columns 0 to
  // 7) at channels 8 (j / 2) to 8 (j / 2) + 7 of each k16 step
  int mrow, mcol, khalf;
  __device__ __forceinline__ uint32_t halo(int i) const {
    return halo0 + (uint32_t)(i * kWgs * kHaloBytes);
  }
  __device__ __forceinline__ uint32_t pairs(int i) const {
    return pairs0 + (uint32_t)(i * kWgs * kPairBytes);
  }
};

// the weights of (step, tap) pair `it`, rows = the step's channels, columns =
// the block's filters, into ring stage it % kStages: a whole slab by the
// offsets the thread computed once, else by stage_tile, which masks rows past
// C and columns past F and takes 2-byte loads where F is no multiple of 8
template <int NB>
__device__ __forceinline__ void stage_weights(const ConvArgs& a, const WgState<NB>& s, int it) {
  if (it >= s.iters) return;
  const int step = it / 9, tap = it - 9 * step;
  const uint32_t dst = s.ring + (uint32_t)((it % kStages) * ConvTile<NB>::kStageBytes);
  if (s.w_whole) {
    const __nv_bfloat16* src = s.wt + ((size_t)tap * a.c + (size_t)step * kKStep) * a.f;
#pragma unroll
    for (int k = 0; k < 2 * NB; ++k) sm90::cp_async_16(dst + s.w_smem[k], src + s.w_gmem[k], 16);
    return;
  }
  sm90::stage_tile<kKStep, 64 * NB, kWgBlockThreads>(
      dst, s.wt + (size_t)tap * a.c * a.f, a.f, step * kKStep, a.c, a.f - s.f0, a.vec_w != 0,
      s.tid);
}

// One (step, tap) pair: wait for its weights, start its products, start
// later loads and normalise one task of the next step while they run, then
// wait for them.
template <int NB>
__device__ __forceinline__ void conv_pair(const ConvArgs& a, const WgState<NB>& s, int it,
                                          float (&acc)[NB * 32]) {
  const int step = it / 9, tap = it - 9 * step;
  // this pair's weights landed in this thread's copies; the barrier makes
  // everyone's visible, says that the stage pair it - 2 read is free (each
  // warpgroup waited for its products before it) and that this step's halo
  // is normalised
  sm90::cp_async_wait<kStages - 3>();
  sm90::fence_proxy_async();
  __syncthreads();
  const int dy = tap / 3, dx = tap - 3 * dy;
  const int p = (s.mrow + dy) * kHSide + s.mcol + dx;
  const uint32_t hb = s.halo(step % kBufs) + (uint32_t)(p * 128);
  uint32_t frag[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::ldmatrix_x4(frag[kk], hb + (uint32_t)(((2 * kk + s.khalf) ^ (p & 7)) << 4));
  // the stage base, opaque to the compiler so that it rebuilds each
  // descriptor with an add instead of holding them all in registers
  uint32_t wst = s.ring + (uint32_t)((it % kStages) * ConvTile<NB>::kStageBytes);
  asm volatile("" : "+r"(wst));
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      sm90::wgmma_rs_m64n64k16<1>(
          reinterpret_cast<float(&)[32]>(acc[32 * cb]), frag[kk],
          sm90::sw128_desc(wst + cb * kKStep * 128 + kk * 16 * 128, kKStep * 128, kSbo), 1);
  sm90::wgmma_commit();
  // a step's first tap: the raw halo of step + 2 into the buffer step - 1
  // was multiplied from; every pair: the weights of it + kStages - 2 into
  // the stage of it - 2
  if (tap == 0 && step + 2 < s.steps)
    stage_halo(s.halo((step + 2) % kBufs), s.pairs((step + 2) % kBufs), a, s.t, step + 2, s.wtid);
  stage_weights<NB>(a, s, it + kStages - 2);
  sm90::cp_async_commit();
  if (tap < kTasks && step + 1 < s.steps) {
    const int q = (s.wtid >> 3) + 16 * tap;
    if (q < kHPx)
      normalise(s.halo((step + 1) % kBufs), s.pairs((step + 1) % kBufs), a, s.t, q, s.wtid & 7);
  }
  sm90::wgmma_wait<0>();
}

template <int NB>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
gn_silu_conv3x3_wgmma_kernel(const __grid_constant__ ConvArgs a) {
  using Tile = ConvTile<NB>;
  extern __shared__ unsigned char smem_raw[];
  WgState<NB> s;
  s.ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  s.tid = threadIdx.x;
  s.wtid = s.tid % kWgThreads;
  const int wg = s.tid / kWgThreads, warp = s.wtid / 32, lane = s.tid % 32;
  s.halo0 = s.ring + Tile::kRing + wg * kHaloBytes;
  s.pairs0 = s.ring + Tile::kRing + Tile::kHalos + wg * kPairBytes;
  s.t = tile_of(blockIdx.x * kWgs + wg, a);
  s.f0 = blockIdx.y * 64 * NB;
  s.steps = (a.c + kKStep - 1) / kKStep;
  s.iters = 9 * s.steps;  // (step, tap) pairs, tap fastest
  s.wt = static_cast<const __nv_bfloat16*>(a.wt) + s.f0;
  s.mrow = 2 * warp + ((lane >> 3) & 1);
  s.mcol = lane & 7;
  s.khalf = lane >> 4;
  s.w_whole = a.vec_w && a.c % kKStep == 0 && a.f - s.f0 >= 64 * NB;
#pragma unroll
  for (int k = 0; k < 2 * NB; ++k) {
    const int id = s.tid + k * kWgBlockThreads, r = id / (8 * NB), chunk = id % (8 * NB);
    s.w_smem[k] = sm90::sw128_offset(r, chunk, kKStep);
    s.w_gmem[k] = (uint32_t)(r * a.f + chunk * 8);
  }

  // prologue: the raw halos of steps 0 and 1 (one group), the weights of the
  // first kStages - 2 pairs (a group each); then step 0's halo normalised
  stage_halo(s.halo(0), s.pairs(0), a, s.t, 0, s.wtid);
  if (s.steps > 1) stage_halo(s.halo(1), s.pairs(1), a, s.t, 1, s.wtid);
  sm90::cp_async_commit();
#pragma unroll 1
  for (int it = 0; it < kStages - 2; ++it) {
    stage_weights<NB>(a, s, it);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kStages - 2>();
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < kTasks; ++j) {
    const int p = (s.wtid >> 3) + 16 * j;
    if (p < kHPx) normalise(s.halo(0), s.pairs(0), a, s.t, p, s.wtid & 7);
  }

  // the sums of the 64 x 64 NB tile: 64-filter block cb at acc[32 cb]
  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < s.iters; ++it) conv_pair<NB>(a, s, it, acc);
  sm90::fence_regs(acc);

  // sums plus the bias, rounded once; acc[32 cb + 4j + 2 half + e] is tile pixel
  // (2 warp + half, lane / 4), filter f0 + 64 cb + 8j + 2 (lane % 4) + e
  if (!s.t.live) return;
  const int xx = s.t.x0 + lane / 4;
  const bool store2 = a.f % 2 == 0;  // bf16 pairs land on 4-byte boundaries
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int yy = s.t.y0 + 2 * warp + half;
    if (yy >= a.h || xx >= a.w) continue;
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(a.out) + (((size_t)s.t.b * a.h + yy) * a.w + xx) * a.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s.f0 + 64 * cb + 8 * j + 2 * (lane % 4);
        if (col >= a.f) continue;
        const float v0 = acc[32 * cb + 4 * j + 2 * half] + a.bias[col];
        if (col + 1 < a.f) {
          const float v1 = acc[32 * cb + 4 * j + 2 * half + 1] + a.bias[col + 1];
          if (store2) {
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[col] = __float2bfloat16(v0);
            dst[col + 1] = __float2bfloat16(v1);
          }
        } else {
          dst[col] = __float2bfloat16(v0);
        }
      }
  }
}

template <int NB>
cudaError_t launch_wgmma(const ConvArgs& a, cudaStream_t stream) {
  auto kernel = gn_silu_conv3x3_wgmma_kernel<NB>;
  constexpr size_t smem = ConvTile<NB>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.tiles + kWgs - 1) / kWgs, (a.f + 64 * NB - 1) / (64 * NB));
  kernel<<<grid, kWgBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// 64-filter blocks a block: the width whose whole waves over `sms`
// multiprocessors cost least, a block costing its filters plus 64 (its
// halo work); a tie goes to the wider
int pick_nb(int tiles, int f, int sms) {
  int best = 3;
  long long best_cost = LLONG_MAX;
  for (int nb = 3; nb >= 1; --nb) {
    const long long blocks =
        (long long)((tiles + kWgs - 1) / kWgs) * ((f + 64 * nb - 1) / (64 * nb));
    const long long cost = (blocks + sms - 1) / sms * (64 * nb + 64);
    if (cost < best_cost) {
      best_cost = cost;
      best = nb;
    }
  }
  return best;
}

cudaError_t launch_f32(const ConvArgs& a, int batch, float* mean, float* rstd, float eps,
                       cudaStream_t stream) {
  group_stats_kernel<float><<<batch * a.groups, kConvThreads, 0, stream>>>(
      static_cast<const float*>(a.x), mean, rstd, a.h * a.w, a.c, a.groups, eps, a, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = gn_silu_conv3x3_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kConvSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.h + kTH - 1) / kTH) * ((a.w + kTW - 1) / kTW);
  dim3 grid(tiles, (a.f + kFT - 1) / kFT, batch);
  kernel<<<grid, kConvThreads, kConvSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const ConvArgs& a, int batch, float* mean, float* rstd, float* ab,
                        float eps, cudaStream_t stream) {
  group_stats_kernel<__nv_bfloat16><<<batch * a.groups, kConvThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), mean, rstd, a.h * a.w, a.c, a.groups, eps, a, ab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  switch (pick_nb(a.tiles, a.f, sms)) {
    case 1: return launch_wgmma<1>(a, stream);
    case 2: return launch_wgmma<2>(a, stream);
    default: return launch_wgmma<3>(a, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of x, wt and out. x is
// (batch, h, w, c) and out (batch, h, w, f), NHWC; wt is (3, 3, c, f); gamma,
// beta (c,) and bias (f,) are f32; es and eb are rows of c elements
// emb_stride apart, f32 if emb_f32 else of x's type, read only if ada; mean
// and rstd are f32 (batch, groups) scratch; ab (bfloat16 only, else null) is
// f32 (batch, cpad, 2) scratch, cpad = c rounded up to a multiple of 64, on a
// 16-byte boundary. All on the current device. Returns the CUDA error code of
// the launches (0 on success).
int nd_gn_silu_conv3x3(const void* x, const void* gamma, const void* beta, const void* es,
                       const void* eb, long long emb_stride, int emb_f32, const void* wt,
                       const void* bias, void* out, void* mean, void* rstd, void* ab, int batch,
                       int h, int w, int c, int f, int groups, float eps, int ada, int dtype,
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
  a.ab = static_cast<const float*>(ab);
  a.cpad = (c + kKStep - 1) / kKStep * kKStep;
  const long long tiles =
      (long long)batch * ((h + kSide - 1) / kSide) * ((w + kSide - 1) / kSide);
  a.tiles = (int)tiles;
  a.vec_x = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_w = f % 8 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean_f = static_cast<float*>(mean);
  float* rstd_f = static_cast<float*>(rstd);
  if (dtype == 0) return (int)launch_f32(a, batch, mean_f, rstd_f, eps, s);
  if (dtype == 1) {
    if (ab == nullptr || reinterpret_cast<uintptr_t>(ab) % 16 != 0 || tiles > INT_MAX - 1)
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(a, batch, mean_f, rstd_f, static_cast<float*>(ab), eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
