// K3: fused GroupNorm (+AdaGN scale-shift) (+SiLU) over NHWC, and its
// backward.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/groupnorm.py ::
// group_norm_fused (pallas_call at :151) and the backward of its custom VJP
// (nicediffusion_tpu/ops/groupnorm.py::_fused_gn, which recomputes the jnp
// op under jax.vjp). For x (B, H*W, C), scale and bias (C,) f32, optional
// modulation rows es, eb (B, C), per example b and group g of C/G channels:
//   n = (x - mean_g) * rstd_g          mean, E[x^2] - mean^2 in f32, eps inside
//   z = n * scale + bias               the normalised value is not rounded
//   u = z * (1 + es) + eb              AdaGN only
//   y = u * sigmoid(u)                 SiLU only; one rounding to x's type
// and, for a cotangent dy, with g_u = dy * SiLU'(u) (or dy), n_g = H*W*C/G:
//   P[b,c] = sum_hw g_u,  Q[b,c] = sum_hw g_u * n
//   d(eb) = P, d(es) = scale * Q + bias * P,
//   d(bias) = sum_b (1 + es) P,  d(scale) = sum_b (1 + es) Q,
//   dx = rstd * (d - mean_g(d) - n * mean_g(d * n)),  d = g_u (1 + es) scale
// where the two group means come from P and Q alone.
//
// What bounds it: bytes. The forward reads x and writes y, the backward
// reads x and dy and writes dx, against some ten f32 operations an element.
// The TPU kernel held one example's whole (H*W, C) block in VMEM and ran one
// program per example. On Hopper one block holds at most 227 KB, and an
// example of the UNets is up to 16.8 MB (128 x 128 x 512 in bf16).
//
// The design, against what held the Triton kernel back (one program per
// (example, group) reading rows of C/G channels at a stride of C, padded to
// a power of two, each element read twice, B * G programs):
//   * Whole rows, coalesced. An example's pixels are cut into row ranges,
//     one a block. A thread owns one 16-byte vector of a row (8 bf16 or 4
//     f32 channels) and walks the block's rows with it, so neighbouring
//     threads read neighbouring addresses and each thread's channels stay
//     fixed: its f32 sums live in registers. Where C is no multiple of a
//     16-byte vector (or x lies off 16 bytes) the vector is 8, 4 or 2 bytes.
//     The block folds its sums over its row phases, then over each group's
//     channels, in shared memory in a fixed order (no atomics: the results
//     are bit-reproducible).
//   * One read of x. The blocks of one example form a thread-block cluster
//     (up to 16 blocks: co-scheduled, so a cluster barrier is safe). Each
//     copies the rows it can hold into shared memory with cp.async, in four
//     commit groups whose statistics are summed as each lands, the blocks
//     trade their group sums through distributed shared memory (mapa), and
//     each normalises and stores the tile it holds. Where a block cannot
//     hold all its rows (the re-read route) it holds the last ones and
//     streams the others through registers twice, the second time mostly
//     from L2 (its cluster read them microseconds before).
//   * Filling the card, and keeping tiles small. A cluster serves one
//     (example, channel slice); the slices are whole groups and at least 128
//     bytes of a row (whole sectors). Slices and cluster size are chosen per
//     call shape by a cost model (make_plan) over the card's own count of
//     the clusters it can hold at once (the occupancy query): waves times a
//     fixed latency plus the bytes a block or the card can move, its
//     constants fitted to every split timed at the UNets' shapes
//     (tools/sweep_groupnorm_plans.py). Slices could make every call of the
//     UNets resident, but more waves of smaller tiles measured slower than
//     one wave that re-reads: the model takes the re-read route at the
//     64 x 64 maps of openai_64 at model batch 16 (slices of 96 to 72
//     channels, clusters of 2, half the rows held) and at openai_128's
//     128 x 128 maps, the resident one elsewhere. HBM bytes: resident,
//     2 |x| (forward) or 3 |x| (backward); re-read, the streamed share of
//     the inputs once more, less what L2 serves.
//   * The arithmetic per element is one FMA for normalise, affine and
//     modulation together (the per-channel scale and shift are fetched into
//     shared memory while the tile lands) and, for SiLU, ex2.approx and a
//     fast divide in f32 or one tanh.approx in bf16 (relative error 2^-11,
//     under bf16's rounding). Measured on the card, this math and too few
//     warps to hide its latency were what held the first version back: up to
//     512 threads a block now.
//   * No padding. C/G is any integer (2 in EMNIST to 64); a thread's vector
//     may span groups, each element finds its own.
//   * The backward is the same shape: one read of x and dy accumulates P and
//     Q per channel, the cluster combines them, the block's first rank writes
//     the (B, C) rows of d(eb), d(es) and the per-example parts of d(bias)
//     and d(scale) (summed over B by the caller in a fixed order), and every
//     block writes dx from the tiles it holds. The forward hands over the
//     (B, G) mean and rstd it used, so the backward does not recompute them.
//
// A launch the card refuses (a cluster that cannot be scheduled, too much
// shared memory) returns its error: nothing falls back.

#include "attention_common.cuh"
#include "sm90.cuh"

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <utility>

namespace {

using nd::from_f32;
using nd::to_f32;

constexpr int kMaxThreads = 512;    // threads a block: enough warps to hide the math's latency
constexpr int kFwdBlocksPerSm = 2;  // the forward in at most 64 registers a thread
constexpr int kBwdBlocksPerSm = 1;  // the backward in at most 128
constexpr int kMaxCluster = 16;     // non-portable above 8
constexpr int kSmemMax = 232448;    // a block's shared memory on sm_90
constexpr int kMaxSliceVecs = kMaxThreads;  // vectors in a slice's row: one a thread
constexpr int kMinRunBytes = 128;   // the shortest row of a channel slice

struct GnArgs {
  const void* x;    // (B, hw, c)
  const void* dy;   // backward: the cotangent, x's type and layout
  void* out;        // forward: y; backward: dx
  const float* scale;
  const float* bias;
  const void* es;   // (B, c) rows emb_stride apart, f32 if emb_f32 else x's type
  const void* eb;
  long long emb_stride;
  int emb_f32;
  float* mean;      // (B, groups): the forward writes them when not null,
  float* rstd;      // the backward reads them
  float* sums;      // backward: (4, B, c) f32: d(eb), d(es), (1 + es) P, (1 + es) Q
  int hw, c, groups, cg;
  int slices, cs;        // channel slices a row is cut into, and channels a slice
  int rows_per_block;    // pixel rows of a block's range
  int res_rows;          // of them, the last res_rows stay in shared memory
  int tile_bytes;        // shared bytes of one tensor's tile (16-byte multiple)
  float eps;
  int ada, silu, want_dx;
};

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using R = typename Raw<V * (int)sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f32(e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using R = typename Raw<V * (int)sizeof(T)>::type;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
  *reinterpret_cast<R*>(p) = raw;
}

// one vector from global to shared memory: cp.async for 4, 8 and 16 bytes
// (the caller commits and waits), a plain copy for 2
template <int BYTES>
__device__ __forceinline__ void copy_to_shared(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(nd::sm90::smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (BYTES >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(nd::sm90::smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// The two halves of a cluster barrier. Every thread of every block of the
// cluster arrives (releasing its shared-memory writes) and waits (acquiring
// the others'). A block arrives a second time when it has read the others'
// shared memory and waits only before it exits, so no block's shared memory
// goes while another may still read it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the generic address of what `p` points to in block `rank`'s shared memory
// (distributed shared memory); plain loads through it can be issued together
__device__ __forceinline__ const float* map_rank(const float* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// the sums of entries i and i + stride of `part` over the cluster's blocks,
// in rank order (every block gets the same bits), four ranks' loads at a time
__device__ __forceinline__ float2 cluster_sum2(const float* part, int i, int stride, int ranks) {
  float2 t = make_float2(0.f, 0.f);
  for (int r0 = 0; r0 < ranks; r0 += 4) {
    float v1[4], v2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v1[r] = v2[r] = 0.f;
      if (r0 + r < ranks) {
        const float* other = map_rank(part, r0 + r);
        v1[r] = other[i];
        v2[r] = other[i + stride];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      t.x += v1[r];
      t.y += v2[r];
    }
  }
  return t;
}

// The resident rows of a thread, k = 0 .. n - 1 (row r_res + ph + k * rt),
// are copied in kGroups commit groups of q rows each; wait_group waits until
// group g has landed (the later ones may still be in flight).
constexpr int kGroups = 4;
template <int G>
__device__ __forceinline__ void wait_group() {
  nd::sm90::cp_async_wait<kGroups - 1 - G>();
}

template <typename T>
__device__ __forceinline__ float load_emb(const void* e, size_t i, int emb_f32) {
  return emb_f32 ? static_cast<const float*>(e)[i] : to_f32(static_cast<const T*>(e)[i]);
}

__device__ __forceinline__ float tanh_approx(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(v));
  return t;
}

// sigmoid(u): for f32, ex2.approx and a fast divide (relative error about
// 2^-21, for the 1e-5 gate); for bf16, 0.5 + 0.5 tanh(u / 2) with one
// tanh.approx (about 2^-11, under bf16's rounding of 2^-9), which halves the
// multifunction-unit work of the normalising pass
template <typename T>
__device__ __forceinline__ float sigmoid(float u) {
  if constexpr (sizeof(T) == 2) return fmaf(0.5f, tanh_approx(0.5f * u), 0.5f);
  return __fdividef(1.f, 1.f + __expf(-u));
}

template <typename T>
__device__ __forceinline__ float silu(float u) {
  if constexpr (sizeof(T) == 2) {
    const float h = 0.5f * u;
    return fmaf(h, tanh_approx(h), h);
  }
  return __fdividef(u, 1.f + __expf(-u));
}

template <typename T>
__device__ __forceinline__ float silu_grad(float u) {
  const float s = sigmoid<T>(u);
  return s * fmaf(u, 1.f - s, 1.f);
}

// Where a block stands: its cluster's (example, slice), its row range, its
// resident rows [r_res, r_hi) and its thread's vector column and row phase.
// The grid is (cluster size, batch * slices) in clusters of (cluster size,
// 1, 1), so a block's rank in its cluster is blockIdx.x.
struct Place {
  int rank, nblocks, b, sl, cs, gs, rt, col, ph, c0, r_lo, r_hi, r_res;
  size_t base;  // element offset of (example b, row 0, this thread's first channel)
};

template <int V>
__device__ __forceinline__ Place place(const GnArgs& a) {
  Place s;
  s.rank = blockIdx.x;
  s.nblocks = gridDim.x;
  s.b = blockIdx.y / a.slices;
  s.sl = blockIdx.y % a.slices;
  s.cs = a.cs;
  s.gs = a.cs / a.cg;
  const int nvs = a.cs / V;
  s.rt = blockDim.x / nvs;
  s.col = threadIdx.x % nvs;
  s.ph = threadIdx.x / nvs;
  s.c0 = s.sl * a.cs;
  s.r_lo = min(a.hw, s.rank * a.rows_per_block);
  s.r_hi = min(a.hw, s.r_lo + a.rows_per_block);
  s.r_res = max(s.r_lo, s.r_hi - a.res_rows);
  s.base = (size_t)s.b * a.hw * a.c + s.c0 + s.col * V;
  return s;
}

// this thread's V channels' affine and modulation: scale * (1 + es) and
// bias * (1 + es) + eb, so that u = n * k + m
template <typename T, int V>
__device__ __forceinline__ void load_affine(const GnArgs& a, const Place& s, float (&k)[V],
                                            float (&m)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = s.c0 + s.col * V + j;
    k[j] = a.scale[ch];
    m[j] = a.bias[ch];
    if (a.ada) {
      const size_t e = (size_t)s.b * a.emb_stride + ch;
      const float sc = 1.f + load_emb<T>(a.es, e, a.emb_f32);
      m[j] = m[j] * sc + load_emb<T>(a.eb, e, a.emb_f32);
      k[j] *= sc;
    }
  }
}

template <int V>
__device__ __forceinline__ void add_stats(const float (&v)[V], float (&s1)[V], float (&s2)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s1[j] += v[j];
    s2[j] = fmaf(v[j], v[j], s2[j]);
  }
}

// y = x * A + B (normalise, affine, modulation in one), then SiLU
template <typename T, int V>
__device__ __forceinline__ void normalise(float (&v)[V], const float (&A)[V], const float (&B)[V],
                                          int with_silu) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float y = fmaf(v[j], A[j], B[j]);
    v[j] = with_silu ? silu<T>(y) : y;
  }
}

// the backward's per-element step: n = x * rstd - mean * rstd in place of x,
// g_u = dy * SiLU'(n * k + m) in place of dy
template <typename T, int V>
__device__ __forceinline__ void grad_u(float (&xv)[V], float (&gv)[V], const float (&rs)[V],
                                       const float (&nmr)[V], const float (&k)[V],
                                       const float (&m)[V], int with_silu) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    xv[j] = fmaf(xv[j], rs[j], nmr[j]);
    if (with_silu) gv[j] *= silu_grad<T>(fmaf(xv[j], k[j], m[j]));
  }
}

// P += g_u, Q += g_u * n
template <int V>
__device__ __forceinline__ void add_pq(const float (&n)[V], const float (&gu)[V], float (&P)[V],
                                       float (&Q)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    P[j] += gu[j];
    Q[j] = fmaf(gu[j], n[j], Q[j]);
  }
}

// dx = rstd g_u k - m1 - n m2 in place of n (m1, m2: rstd times the group
// means of d and of d n)
template <int V>
__device__ __forceinline__ void dx_vec(float (&n)[V], const float (&gu)[V], const float (&rs)[V],
                                       const float (&k)[V], const float (&m1)[V],
                                       const float (&m2)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) n[j] = fmaf(rs[j] * gu[j], k[j], -fmaf(n[j], m2[j], m1[j]));
}

// a block's per-thread sums (red, [2][rt][cs]) over its row phases, per
// channel of the slice, into out[i] and out[cs + i], in a fixed order
__device__ __forceinline__ void fold_phases(const float* red, float* out, int rt, int cs) {
  for (int i = threadIdx.x; i < cs; i += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < rt; ++q) {
      t1 += red[q * cs + i];
      t2 += red[(rt + q) * cs + i];
    }
    out[i] = t1;
    out[cs + i] = t2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, kFwdBlocksPerSm)
group_norm_fwd_kernel(const GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place s = place<V>(a);
  const int cs = s.cs, rt = s.rt;
  const size_t ld = a.c;
  const T* xb = static_cast<const T*>(a.x) + s.base;
  T* yb = static_cast<T*>(a.out) + s.base;
  T* tile = reinterpret_cast<T*>(smem) + s.col * V;  // resident row r at r * cs
  float* red = reinterpret_cast<float*>(smem + a.tile_bytes);  // [2][rt][cs]
  float* chan = red + 2 * rt * cs;  // [2][cs]: the block's sums per channel
  float* part = chan + 2 * cs;      // [2][cs]: per group, read by the cluster
  float* stat = part + 2 * cs;      // [2][cs]: each group's mean and rstd
  float* coef = stat + 2 * cs;      // [2][cs]: scale (1 + es), bias (1 + es) + eb

  // the resident rows land in the background, in kGroups groups, while the
  // others stream; row k of this thread is tile row ph + k * rt
  const int nres = (s.r_hi - s.r_res - s.ph + rt - 1) / rt;
  const int q = ((s.r_hi - s.r_res + rt - 1) / rt + kGroups - 1) / kGroups;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    for (int k = g * q; k < min(nres, (g + 1) * q); ++k) {
      const int r = s.ph + k * rt;
      copy_to_shared<V * (int)sizeof(T)>(tile + (size_t)r * cs, xb + (size_t)(s.r_res + r) * ld);
    }
    nd::sm90::cp_async_commit();
  }

  // the affine and modulation, fetched while the tile lands
  for (int i = threadIdx.x; i < cs; i += blockDim.x) {
    const int ch = s.c0 + i;
    float k = a.scale[ch], m = a.bias[ch];
    if (a.ada) {
      const size_t e = (size_t)s.b * a.emb_stride + ch;
      const float sc = 1.f + load_emb<T>(a.es, e, a.emb_f32);
      m = m * sc + load_emb<T>(a.eb, e, a.emb_f32);
      k *= sc;
    }
    coef[i] = k;
    coef[cs + i] = m;
  }
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  int p = s.r_lo + s.ph;
  for (; p + rt < s.r_res; p += 2 * rt) {
    float v[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u) load_vec<T, V>(xb + (size_t)(p + u * rt) * ld, v[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u) add_stats<V>(v[u], s1, s2);
  }
  for (; p < s.r_res; p += rt) {
    float v[V];
    load_vec<T, V>(xb + (size_t)p * ld, v);
    add_stats<V>(v, s1, s2);
  }
  // this thread's own copies: no block barrier needed
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == 0) wait_group<0>();
    if (g == 1) wait_group<1>();
    if (g == 2) wait_group<2>();
    if (g == 3) wait_group<3>();
    const int k1 = min(nres, (g + 1) * q);
    int k = g * q;
    for (; k + 1 < k1; k += 2) {
      float v[2][V];
#pragma unroll
      for (int u = 0; u < 2; ++u) load_vec<T, V>(tile + (size_t)(s.ph + (k + u) * rt) * cs, v[u]);
#pragma unroll
      for (int u = 0; u < 2; ++u) add_stats<V>(v[u], s1, s2);
    }
    if (k < k1) {
      float v[V];
      load_vec<T, V>(tile + (size_t)(s.ph + k * rt) * cs, v);
      add_stats<V>(v, s1, s2);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[s.ph * cs + s.col * V + j] = s1[j];
    red[(rt + s.ph) * cs + s.col * V + j] = s2[j];
  }
  __syncthreads();
  fold_phases(red, chan, rt, cs);
  __syncthreads();
  for (int gi = threadIdx.x; gi < s.gs; gi += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < a.cg; ++k) {
      t1 += chan[gi * a.cg + k];
      t2 += chan[cs + gi * a.cg + k];
    }
    part[gi] = t1;
    part[cs + gi] = t2;
  }
  cluster_sync();  // every block's group sums are in its shared memory
  for (int gi = threadIdx.x; gi < s.gs; gi += blockDim.x) {
    const float2 t = cluster_sum2(part, gi, cs, s.nblocks);
    const float n = (float)a.hw * (float)a.cg;
    const float m = t.x / n;
    const float var = t.y / n - m * m;
    const float rs = 1.f / sqrtf(var + a.eps);
    stat[gi] = m;
    stat[cs + gi] = rs;
    if (s.rank == 0 && a.mean != nullptr) {
      const int at = s.b * a.groups + s.sl * s.gs + gi;
      a.mean[at] = m;
      a.rstd[at] = rs;
    }
  }
  cluster_arrive();
  __syncthreads();

  // y = ((x - mean) rstd scale + bias)(1 + es) + eb = x * A + B
  float A[V], B[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = s.col * V + j, gi = i / a.cg;
    const float rs = stat[cs + gi];
    B[j] = fmaf(-stat[gi] * rs, coef[i], coef[cs + i]);
    A[j] = coef[i] * rs;
  }
  int k = 0;
  for (; k + 1 < nres; k += 2) {
    float v[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u) load_vec<T, V>(tile + (size_t)(s.ph + (k + u) * rt) * cs, v[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      normalise<T, V>(v[u], A, B, a.silu);
      store_vec<T, V>(yb + (size_t)(s.r_res + s.ph + (k + u) * rt) * ld, v[u]);
    }
  }
  for (; k < nres; ++k) {
    float v[V];
    load_vec<T, V>(tile + (size_t)(s.ph + k * rt) * cs, v);
    normalise<T, V>(v, A, B, a.silu);
    store_vec<T, V>(yb + (size_t)(s.r_res + s.ph + k * rt) * ld, v);
  }
  // the re-read route: the rows that did not fit, again from global memory
  for (p = s.r_lo + s.ph; p + rt < s.r_res; p += 2 * rt) {
    float v[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u) load_vec<T, V>(xb + (size_t)(p + u * rt) * ld, v[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      normalise<T, V>(v[u], A, B, a.silu);
      store_vec<T, V>(yb + (size_t)(p + u * rt) * ld, v[u]);
    }
  }
  for (; p < s.r_res; p += rt) {
    float v[V];
    load_vec<T, V>(xb + (size_t)p * ld, v);
    normalise<T, V>(v, A, B, a.silu);
    store_vec<T, V>(yb + (size_t)p * ld, v);
  }
  cluster_wait();
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, kBwdBlocksPerSm)
group_norm_bwd_kernel(const GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place s = place<V>(a);
  const int cs = s.cs, rt = s.rt;
  const size_t ld = a.c;
  const T* xb = static_cast<const T*>(a.x) + s.base;
  const T* gb = static_cast<const T*>(a.dy) + s.base;
  T* dxb = static_cast<T*>(a.out) + s.base;
  T* xt = reinterpret_cast<T*>(smem) + s.col * V;
  T* gt = reinterpret_cast<T*>(smem + a.tile_bytes) + s.col * V;
  float* red = reinterpret_cast<float*>(smem + 2 * a.tile_bytes);  // [2][rt][cs]
  float* part = red + 2 * rt * cs;  // [2][cs]: this block's P and Q, read by the cluster
  float* tot = part + 2 * cs;       // [2][cs]: the cluster's P and Q
  float* stat = tot + 2 * cs;       // [2][cs]: each group's mean(d) and mean(d n)

  const int nres = (s.r_hi - s.r_res - s.ph + rt - 1) / rt;
  const int q = ((s.r_hi - s.r_res + rt - 1) / rt + kGroups - 1) / kGroups;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    for (int k = g * q; k < min(nres, (g + 1) * q); ++k) {
      const int r = s.ph + k * rt;
      const size_t at = (size_t)r * cs, row = (size_t)(s.r_res + r) * ld;
      copy_to_shared<V * (int)sizeof(T)>(xt + at, xb + row);
      copy_to_shared<V * (int)sizeof(T)>(gt + at, gb + row);
    }
    nd::sm90::cp_async_commit();
  }

  // n = x * rs + nmr, u = n * k + m; d = g_u * k
  float rs[V], nmr[V], k[V], m[V];
  load_affine<T, V>(a, s, k, m);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int at = s.b * a.groups + (s.c0 + s.col * V + j) / a.cg;
    rs[j] = a.rstd[at];
    nmr[j] = -a.mean[at] * rs[j];
  }
  float P[V], Q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) P[j] = Q[j] = 0.f;
  int p = s.r_lo + s.ph;
  for (; p + rt < s.r_res; p += 2 * rt) {
    float xv[2][V], gv[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      load_vec<T, V>(xb + (size_t)(p + u * rt) * ld, xv[u]);
      load_vec<T, V>(gb + (size_t)(p + u * rt) * ld, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      grad_u<T, V>(xv[u], gv[u], rs, nmr, k, m, a.silu);
      add_pq<V>(xv[u], gv[u], P, Q);
    }
  }
  for (; p < s.r_res; p += rt) {
    float xv[V], gv[V];
    load_vec<T, V>(xb + (size_t)p * ld, xv);
    load_vec<T, V>(gb + (size_t)p * ld, gv);
    grad_u<T, V>(xv, gv, rs, nmr, k, m, a.silu);
    add_pq<V>(xv, gv, P, Q);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == 0) wait_group<0>();
    if (g == 1) wait_group<1>();
    if (g == 2) wait_group<2>();
    if (g == 3) wait_group<3>();
    for (int kk = g * q; kk < min(nres, (g + 1) * q); ++kk) {
      float xv[V], gv[V];
      const size_t at = (size_t)(s.ph + kk * rt) * cs;
      load_vec<T, V>(xt + at, xv);
      load_vec<T, V>(gt + at, gv);
      grad_u<T, V>(xv, gv, rs, nmr, k, m, a.silu);
      add_pq<V>(xv, gv, P, Q);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[s.ph * cs + s.col * V + j] = P[j];
    red[(rt + s.ph) * cs + s.col * V + j] = Q[j];
  }
  __syncthreads();
  fold_phases(red, part, rt, cs);
  cluster_sync();
  const int batch = gridDim.y / a.slices;
  for (int i = threadIdx.x; i < cs; i += blockDim.x) {
    const float2 t = cluster_sum2(part, i, cs, s.nblocks);
    tot[i] = t.x;
    tot[cs + i] = t.y;
    if (s.rank == 0) {
      const int ch = s.c0 + i;
      float sc = 1.f;
      if (a.ada) sc += load_emb<T>(a.es, (size_t)s.b * a.emb_stride + ch, a.emb_f32);
      const size_t at = (size_t)s.b * a.c + ch, plane = (size_t)batch * a.c;
      a.sums[at] = t.x;
      a.sums[plane + at] = a.scale[ch] * t.y + a.bias[ch] * t.x;
      a.sums[2 * plane + at] = sc * t.x;
      a.sums[3 * plane + at] = sc * t.y;
    }
  }
  cluster_arrive();
  __syncthreads();
  if (a.want_dx) {
    const float inv_n = 1.f / ((float)a.hw * (float)a.cg);
    for (int gi = threadIdx.x; gi < s.gs; gi += blockDim.x) {
      float m1 = 0.f, m2 = 0.f;
      for (int c = 0; c < a.cg; ++c) {
        const int i = gi * a.cg + c, ch = s.c0 + i;
        float w = a.scale[ch];
        if (a.ada) w *= 1.f + load_emb<T>(a.es, (size_t)s.b * a.emb_stride + ch, a.emb_f32);
        m1 = fmaf(w, tot[i], m1);
        m2 = fmaf(w, tot[cs + i], m2);
      }
      stat[gi] = m1 * inv_n;
      stat[cs + gi] = m2 * inv_n;
    }
    __syncthreads();
    // dx = rstd (g_u k - mean(d) - n mean(d n)), with rstd * mean(d) as m1
    float m1[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int gi = (s.col * V + j) / a.cg;
      m1[j] = stat[gi] * rs[j];
      m2[j] = stat[cs + gi] * rs[j];
    }
    int kk = 0;
    for (; kk + 1 < nres; kk += 2) {
      float xv[2][V], gv[2][V];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const size_t at = (size_t)(s.ph + (kk + u) * rt) * cs;
        load_vec<T, V>(xt + at, xv[u]);
        load_vec<T, V>(gt + at, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        grad_u<T, V>(xv[u], gv[u], rs, nmr, k, m, a.silu);
        dx_vec<V>(xv[u], gv[u], rs, k, m1, m2);
        store_vec<T, V>(dxb + (size_t)(s.r_res + s.ph + (kk + u) * rt) * ld, xv[u]);
      }
    }
    if (kk < nres) {
      float xv[V], gv[V];
      const size_t at = (size_t)(s.ph + kk * rt) * cs;
      load_vec<T, V>(xt + at, xv);
      load_vec<T, V>(gt + at, gv);
      grad_u<T, V>(xv, gv, rs, nmr, k, m, a.silu);
      dx_vec<V>(xv, gv, rs, k, m1, m2);
      store_vec<T, V>(dxb + (size_t)(s.r_res + s.ph + kk * rt) * ld, xv);
    }
    for (p = s.r_lo + s.ph; p + rt < s.r_res; p += 2 * rt) {
      float xv[2][V], gv[2][V];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        load_vec<T, V>(xb + (size_t)(p + u * rt) * ld, xv[u]);
        load_vec<T, V>(gb + (size_t)(p + u * rt) * ld, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        grad_u<T, V>(xv[u], gv[u], rs, nmr, k, m, a.silu);
        dx_vec<V>(xv[u], gv[u], rs, k, m1, m2);
        store_vec<T, V>(dxb + (size_t)(p + u * rt) * ld, xv[u]);
      }
    }
    for (; p < s.r_res; p += rt) {
      float xv[V], gv[V];
      load_vec<T, V>(xb + (size_t)p * ld, xv);
      load_vec<T, V>(gb + (size_t)p * ld, gv);
      grad_u<T, V>(xv, gv, rs, nmr, k, m, a.silu);
      dx_vec<V>(xv, gv, rs, k, m1, m2);
      store_vec<T, V>(dxb + (size_t)p * ld, xv);
    }
  }
  cluster_wait();
}

// ------------------------------------------------------------------ host

using Kernel = void (*)(GnArgs);

struct Plan {
  int vec, slices, cluster, threads, rows_per_block, res_rows, tile_bytes, smem;
};

struct PlanKey {
  int dev, backward, esize, vec, batch, hw, c, groups;
  bool operator==(const PlanKey& o) const {
    return dev == o.dev && backward == o.backward && esize == o.esize && vec == o.vec &&
           batch == o.batch && hw == o.hw && c == o.c && groups == o.groups;
  }
};

constexpr int kCache = 256;
std::mutex g_mutex;
PlanKey g_keys[kCache];
Plan g_plans[kCache];
int g_cached = 0;

// the shared memory of a plan: one tile a tensor, the phase sums, and
// 8 * cs floats of per-channel sums, cluster partials, group statistics and
// the forward's per-channel affine
size_t scratch_bytes(int rt, int cs) { return sizeof(float) * (size_t)(2 * rt * cs + 8 * cs); }

// The cost model the plan is chosen by (microseconds): a wave of blocks takes
// a fixed latency (loads, barriers, the cluster's exchange, growing with the
// cluster) plus its bytes, at what one block can pull or the card's share of
// the wave, whichever is slower; the waves follow from how many clusters of
// the candidate the card holds at once (the occupancy query, which counts
// the shared memory, the threads and the cluster's placement in a GPC).
constexpr double kFixedUs = 3.0;
constexpr double kClusterUs = 0.1;          // a block of the cluster more
constexpr double kBlockBytesPerUs = 2.4e4;  // 24 GB/s one block
constexpr double kCardBytesPerUs = 1.5e6;   // 1.5 TB/s the card

// Every (slices, cluster) split of the call (or the one forced, if force_s
// and force_cl are not 0); the one of least modelled time whose cluster the
// card can schedule, a tie to the fewer slices and then the smaller cluster.
cudaError_t make_plan(Kernel kernel, const PlanKey& k, Plan* out, int force_s = 0,
                      int force_cl = 0) {
  const int tensors = k.backward ? 2 : 1;
  bool found = false;
  double best = 0.0;
  for (int s = 1; s <= k.groups; ++s) {
    if (k.groups % s) continue;
    const int cs = k.c / s;
    if (cs % k.vec) continue;
    const int nvs = cs / k.vec;
    if (nvs > kMaxSliceVecs) continue;
    if (s > 1 && cs * k.esize < kMinRunBytes) continue;
    if ((long long)k.batch * s > 65535 || (force_s && s != force_s)) continue;
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      const int rpb = (k.hw + cl - 1) / cl;
      if (cl > 1 && (k.hw + cl / 2 - 1) / (cl / 2) == rpb) break;  // no fewer rows a block
      if (force_cl && cl != force_cl) continue;
      const int rt = std::max(1, std::min(kMaxThreads / nvs, rpb));
      const size_t scratch = scratch_bytes(rt, cs);
      const size_t row = (size_t)cs * k.esize;
      if (scratch + 16 * tensors > (size_t)kSmemMax) continue;
      const long long fit = (long long)((kSmemMax - scratch - 16 * tensors) / (row * tensors));
      const int res = (int)std::min<long long>(rpb, fit);
      const int tile = (int)(((size_t)res * row + 15) / 16 * 16);
      const Plan plan = {k.vec, s, cl, nvs * rt, rpb, res, tile,
                         (int)(tensors * tile + scratch)};
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cl, 1, 1);
      cfg.blockDim = dim3(plan.threads, 1, 1);
      cfg.dynamicSmemBytes = plan.smem;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cl;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int active = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (active <= 0) continue;
      const long long clusters = (long long)k.batch * s;
      const long long waves = (clusters + active - 1) / active;
      const long long per_wave = std::min<long long>(clusters, active) * cl;
      // a block moves its rows of every tensor in and out once, its streamed
      // rows of the inputs once more
      const double block_bytes = (double)row * ((tensors + 1) * rpb + tensors * (rpb - res));
      const double us = waves * (kFixedUs + kClusterUs * cl +
                                 std::max(block_bytes / kBlockBytesPerUs,
                                          per_wave * block_bytes / kCardBytesPerUs));
      if (!found || us < best) {
        found = true;
        best = us;
        *out = plan;
      }
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidConfiguration;  // nothing fits the card
}

// the cached plan of a call; with force_s and force_cl, that split replaces it
cudaError_t get_plan(Kernel kernel, const PlanKey& k, Plan* out, int force_s = 0,
                     int force_cl = 0) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int slot = -1;
  for (int i = 0; i < std::min(g_cached, kCache); ++i)
    if (g_keys[i] == k) slot = i;
  if (slot >= 0 && !force_s) {
    *out = g_plans[slot];
    return cudaSuccess;
  }
  cudaError_t err = make_plan(kernel, k, out, force_s, force_cl);
  if (err != cudaSuccess) return err;
  if (slot < 0) slot = g_cached++ % kCache;
  g_keys[slot] = k;
  g_plans[slot] = *out;
  return cudaSuccess;
}

template <typename T, int V>
Kernel kernel_for(int backward) {
  return backward ? group_norm_bwd_kernel<T, V> : group_norm_fwd_kernel<T, V>;
}

// the kernel of a type and vector width, its shared-memory and cluster
// attributes set on the current device at its first call there
cudaError_t pick_kernel(int dtype, int vec, int backward, int dev, Kernel* kernel) {
  constexpr int kDevices = 16;
  static bool ready[2][2][5][kDevices] = {};  // [dtype][backward][log2 vec][device]
  Kernel kern = nullptr;
  int slot = 0;
  if (dtype == 0) {
    switch (vec) {
      case 4: kern = kernel_for<float, 4>(backward); slot = 2; break;
      case 2: kern = kernel_for<float, 2>(backward); slot = 1; break;
      case 1: kern = kernel_for<float, 1>(backward); slot = 0; break;
    }
  } else {
    switch (vec) {
      case 8: kern = kernel_for<__nv_bfloat16, 8>(backward); slot = 3; break;
      case 4: kern = kernel_for<__nv_bfloat16, 4>(backward); slot = 2; break;
      case 2: kern = kernel_for<__nv_bfloat16, 2>(backward); slot = 1; break;
      case 1: kern = kernel_for<__nv_bfloat16, 1>(backward); slot = 0; break;
    }
  }
  if (kern == nullptr || dev < 0) return cudaErrorInvalidValue;
  *kernel = kern;
  std::lock_guard<std::mutex> lock(g_mutex);
  bool* flag = dev < kDevices ? &ready[dtype][backward][slot][dev] : nullptr;
  if (flag != nullptr && *flag) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && flag != nullptr) *flag = true;
  return err;
}

// elements of the widest vector (16, 8, 4 or 2 bytes) that divides a row and
// every pointer's alignment
int vector_width(int c, int esize, uintptr_t align) {
  int vec = 16 / esize;
  while (vec > 1 && (c % vec != 0 || align % (uintptr_t)(vec * esize) != 0)) vec /= 2;
  return vec;
}

cudaError_t plan_call(int dtype, int backward, int batch, int hw, int c, int groups,
                      uintptr_t align, Kernel* kernel, Plan* plan, int force_s = 0,
                      int force_cl = 0) {
  if (batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  PlanKey k;
  cudaError_t err = cudaGetDevice(&k.dev);
  if (err != cudaSuccess) return err;
  k.backward = backward;
  k.esize = esize;
  k.vec = vector_width(c, esize, align);
  k.batch = batch;
  k.hw = hw;
  k.c = c;
  k.groups = groups;
  err = pick_kernel(dtype, k.vec, backward, k.dev, kernel);
  if (err != cudaSuccess) return err;
  return get_plan(*kernel, k, plan, force_s, force_cl);
}

cudaError_t launch(Kernel kernel, const Plan& p, GnArgs a, int batch, cudaStream_t stream) {
  a.slices = p.slices;
  a.cs = a.c / p.slices;
  a.cg = a.c / a.groups;
  a.rows_per_block = p.rows_per_block;
  a.res_rows = p.res_rows;
  a.tile_bytes = p.tile_bytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, batch * p.slices, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = p.cluster > 1;  // a lone block is a cluster of one without it
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

uintptr_t alignment(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 16;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits & (~bits + 1);  // the lowest set bit: the largest power of two dividing all
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of x and out. x and out are
// (batch, hw, c) contiguous; scale and bias (c,) f32; es and eb rows of c
// elements emb_stride apart, f32 if emb_f32 else of x's type, read only if
// ada; mean and rstd f32 (batch, groups), written if not null. All on the
// current device. Returns the CUDA error code (0 on success).
int nd_group_norm_fwd(const void* x, void* out, const void* scale, const void* bias,
                      const void* es, const void* eb, long long emb_stride, int emb_f32,
                      void* mean, void* rstd, int batch, int hw, int c, int groups, float eps,
                      int ada, int silu, int dtype, void* stream) {
  Kernel kernel;
  Plan plan;
  cudaError_t err = plan_call(dtype, 0, batch, hw, c, groups, alignment({x, out}), &kernel, &plan);
  if (err != cudaSuccess) return (int)err;
  GnArgs a = {};
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.es = es;
  a.eb = eb;
  a.emb_stride = emb_stride;
  a.emb_f32 = emb_f32;
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.hw = hw;
  a.c = c;
  a.groups = groups;
  a.eps = eps;
  a.ada = ada;
  a.silu = silu;
  return (int)launch(kernel, plan, a, batch, static_cast<cudaStream_t>(stream));
}

// The backward of nd_group_norm_fwd: dy the cotangent (x's type and layout),
// mean and rstd the forward's, dx (x's type and layout) written if want_dx;
// sums f32 (4, batch, c): d(eb), d(es), and (1 + es) P and (1 + es) Q per
// example, whose sums over the batch are d(bias) and d(scale).
int nd_group_norm_bwd(const void* x, const void* dy, void* dx, const void* scale,
                      const void* bias, const void* es, const void* eb, long long emb_stride,
                      int emb_f32, const void* mean, const void* rstd, void* sums, int batch,
                      int hw, int c, int groups, int ada, int silu, int want_dx, int dtype,
                      void* stream) {
  if (mean == nullptr || rstd == nullptr || sums == nullptr || (want_dx && dx == nullptr))
    return (int)cudaErrorInvalidValue;
  Kernel kernel;
  Plan plan;
  cudaError_t err = plan_call(dtype, 1, batch, hw, c, groups,
                              alignment({x, dy, want_dx ? dx : x}), &kernel, &plan);
  if (err != cudaSuccess) return (int)err;
  GnArgs a = {};
  a.x = x;
  a.dy = dy;
  a.out = dx;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.es = es;
  a.eb = eb;
  a.emb_stride = emb_stride;
  a.emb_f32 = emb_f32;
  a.mean = const_cast<float*>(static_cast<const float*>(mean));
  a.rstd = const_cast<float*>(static_cast<const float*>(rstd));
  a.sums = static_cast<float*>(sums);
  a.hw = hw;
  a.c = c;
  a.groups = groups;
  a.ada = ada;
  a.silu = silu;
  a.want_dx = want_dx;
  return (int)launch(kernel, plan, a, batch, static_cast<cudaStream_t>(stream));
}

// The split a call of these shapes takes on the current device, into
// out[0..7]: vector elements, channel slices, cluster size, threads a block,
// rows a block, of them held in shared memory, tile bytes, shared bytes.
// align: the largest power of two (at most 16) dividing the tensors' byte
// addresses.
// With slices and cluster not 0, that split replaces the call's plan on this
// device for every later call of these shapes (for measuring the splits
// against each other; cudaErrorInvalidConfiguration if it is no valid split).
int nd_group_norm_plan(int batch, int hw, int c, int groups, int dtype, int backward, int align,
                       int slices, int cluster, int* out) {
  Kernel kernel;
  Plan p;
  cudaError_t err = plan_call(dtype, backward, batch, hw, c, groups, (uintptr_t)align, &kernel, &p,
                              slices, cluster);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {p.vec, p.slices, p.cluster, p.threads, p.rows_per_block, p.res_rows,
                       p.tile_bytes, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
