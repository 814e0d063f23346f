// K2: cotangent of the fused-qkv attention (K1) with respect to qkv.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/attention.py ::
// mha_attention_fused_qkv_bwd (body _fused_bwd_kernel). From the projection
// qkv (B, N, 3C), the output cotangent g (B, N, C), the forward output o
// (B, N, C) and the row log-sum-exp lse (B, H, N, f32) that K1 wrote beside
// o, it computes, per batch element and head,
//   p = exp(q k^T * scale - lse)      recomputed, never stored in device memory
//   delta = rowsum(g * o)             (== rowsum(dp * p), the softmax trick)
//   dv = p^T g;  dp = g v^T;  ds = p * (dp - delta) * scale
//   dq = ds k;   dk = ds^T q
// and writes dq, dk and dv at the channel offsets of q, k and v in a
// (B, N, 3C) tensor, in either qkv layout. lse is ln sum_j exp(scale q k_j),
// natural log (attention.cu). The JAX package's custom VJP keeps qkv and o
// only and its kernel takes the softmax over a whole key row at once; the
// values here are the same.
//
// Design. The TPU kernel ran one program per batch element, unrolled the
// heads, kept whole (N, hc) dk and dv sums in VMEM across a sequential loop
// of query tiles. On Hopper blocks run in no order, so the work is cut
// twice, with no atomics (the result is the same from run to run):
//   * dq kernel, one block per (query tiles, head, batch element): holds its
//     q and g tiles, takes delta from g and o (and leaves it in a small f32
//     (B, H, N) scratch tensor for the other kernel), walks the 64-key tiles
//     once, recomputes p from lse and accumulates dq.
//   * dk/dv kernel, one block per (key tiles, head, batch element): holds
//     its k and v tiles, walks the 64-query tiles, recomputes p and ds from
//     lse and delta and accumulates dk and dv.
// Rows past N load as zero and are never stored; keys past N get p = 0;
// every element of the output belonging to a row below N is written by
// exactly one thread. Rounding follows the TPU kernel: p is rounded to the
// input type before p^T g, and ds (made from the rounded p) before ds k and
// ds^T q; all sums are f32.
//
// bf16: the tensor cores (the *_wgmma kernels), built like K1's bf16 kernel
// from csrc/sm90.cuh. One warpgroup (128 threads) owns a 64-row tile.
//   * dq: S = Q K^T and dP = G V^T are wgmma m64n64k16 products with both
//     operands read from shared memory, K-major, as K1's S. p and ds are
//     formed in the accumulator layout; packed to bf16 pairs they are the A
//     fragment of dQ += dS K (the rounding to bf16 is the packing), with K
//     the B operand in MN-major form, as it lies.
//   * dk/dv: the transposed tiles S^T = K Q^T and dP^T = V G^T, so that P^T
//     and dS^T come out with keys as rows and feed dV += P^T G and dK +=
//     dS^T Q as register A fragments, G and Q MN-major B operands. lse and
//     delta are then per column: each query tile's 64 values of each are
//     staged in shared memory beside it.
//   * The streamed tiles (K and V, or Q and G) go through a two-stage ring of
//     16-byte cp.async in the 128-byte swizzle: tile t + 1 loads while tile t
//     multiplies. Head dim 32 is staged 64 columns wide (zeros past 32). The
//     wrapper hands 16-byte-aligned tensors.
//   * dP (dP^T) is issued as its own commit group after S: p is formed from
//     S while dP multiplies.
// Budget per head dim D. Registers a thread: an f32 64 x D accumulator is
// D / 2, S and dP 32 each, the packed p and ds 16 each. dq holds D / 2 + 96
// at most; dk/dv with both sums D + 96, which fits at D <= 128 only. So:
//   * D <= 128: two warpgroups a block (two own tiles sharing the ring), dk
//     and dv in one block.
//   * D = 192, 256: one warpgroup a block (two owned and four streamed tiles
//     of 64 x D bf16 are 197,632 bytes at 256), dV and dK in separate blocks
//     of one launch (the even and odd x indices of a key tile: D / 2 + 96
//     registers each, one more product pass, twice the blocks on the small
//     grids these head dims come with), and dP issued only once p is packed,
//     so S and dP are never live together.
// The registers and spills ptxas reports for each instantiation are printed
// by chip_smoke.py's [build] phase; PERF.md keeps them.
//
// What bounds it. Operations: per (query tile, key tile) pair and per head
// the formulas need five 64 x 64 x D products (S, dP, dV, dQ, dK). Without
// atomics S and dP are made twice, once in each kernel: seven at D <= 128,
// and eight at 192 and 256, where the dV blocks make S once more. The price
// of no atomics is 7/5 of the tensor-core bound. At the training shapes (N =
// 1024) the bound is operations: 5 * 2 N^2 C flops against 8 N C bf16 bytes.
// As K1, the exponentials and the shared-memory reads of the operands run
// in turn with the products inside a warpgroup; other warpgroups fill the
// gaps.
//
// f32: the CUDA cores (attention_bwd_dq_kernel, attention_bwd_dkv_kernel),
// f32 FMA, so f32 inputs never see TF32 (their 2e-5 gate leaves no room for
// it). Tiling, in-kernel offsets and the one-word bank padding are K1's f32
// kernel's. At head dims 192 and 256 four 64-row f32 tiles of HC + 1 words do
// not fit a block's 232,448 B, so there the tile a block owns has 32 rows
// while the tiles it walks keep 64.

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

using namespace nd;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- f32, FMA

// rows of the tile a block owns: 32 at the head dims whose 64-row tiles do
// not fit a block's shared memory
template <int HC>
constexpr int own_rows() {
  return HC > 128 ? 32 : 64;
}

template <int HC, int BM>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * (BM + kBN) * (HC + 1) + BM * kPStride);
}

template <int HC, int BN>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * (BN + kBM) * (HC + 1) + 2 * kBM * (BN + 4) + 2 * kBM);
}

// rows [row0, row0 + ROWS) of one head's hc channels -> a shared tile of row
// stride HC + 1, zero past row n
template <int HC, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t row_stride,
                                          int row0, int n, int tid) {
  for (int i = tid; i < ROWS * HC; i += kThreads) {
    const int r = i / HC, d = i % HC, row = row0 + r;
    dst[r * (HC + 1) + d] = row < n ? src[(size_t)row * row_stride + d] : 0.f;
  }
}

template <int HC, int BM>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                        const float* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ dqkv, float* __restrict__ delta, int n, int c,
                        int split_first, float scale) {
  constexpr int kS = HC + 1;
  constexpr int kOC = HC / 16;  // dq columns per thread
  constexpr int TR = BM / 16;   // query rows per thread: ty * TR + i
  extern __shared__ float smem[];
  float* qs = smem;             // BM x kS
  float* gs = qs + BM * kS;     // BM x kS
  float* ks = gs + BM * kS;     // kBN x kS
  float* vs = ks + kBN * kS;    // kBN x kS
  float* dss = vs + kBN * kS;   // BM x kPStride

  const int q0 = blockIdx.x * BM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, HC, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * HC;
  const float* obase = o + (size_t)b * n * c + head * HC;

  load_tile<HC, BM>(qs, base + off.q, c3, q0, n, tid);
  load_tile<HC, BM>(gs, gbase, c, q0, n, tid);
  __syncthreads();

  // the log-sum-exp of this thread's rows, and delta = rowsum(g * o)
  float row_lse[TR], row_delta[TR];
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i, row = q0 + r;
    row_lse[i] = row < n ? lse[stat_base + row] : 0.f;
    float acc = 0.f;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < kOC; ++j) {
        const int d = tx + 16 * j;
        acc = fmaf(gs[r * kS + d], obase[(size_t)row * c + d], acc);
      }
    }
    row_delta[i] = row_sum16(acc);
    if (tx == 0 && row < n) delta[stat_base + row] = row_delta[i];
  }

  // recompute p, form ds, accumulate dq = ds k
  float dq[TR][kOC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    load_tile<HC>(ks, base + off.k, c3, k0, n, tid);
    load_tile<HC>(vs, base + off.v, c3, k0, n, tid);
    __syncthreads();
    float s[TR][kTC], dp[TR][kTC];
    tile_dot_nt<HC, TR>(qs, ks, ty, tx, s);
    tile_dot_nt<HC, TR>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const bool valid = k0 + tx + 16 * j < n;
        const float p = valid ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty * TR + i) * kPStride + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBN; ++k) {
      float dv_[TR], kv[kOC];
#pragma unroll
      for (int i = 0; i < TR; ++i) dv_[i] = dss[(ty * TR + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOC; ++j) kv[j] = ks[k * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) dq[i][j] = fmaf(dv_[i], kv[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= n) continue;
    float* dst = dqkv + ((size_t)b * n + row) * c3 + off.q;
#pragma unroll
    for (int j = 0; j < kOC; ++j) dst[tx + 16 * j] = dq[i][j];
  }
}

template <int HC, int BN>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dqkv, int n, int c, int split_first, float scale) {
  constexpr int kS = HC + 1;
  constexpr int kOC = HC / 16;  // dk and dv columns per thread
  constexpr int TC = BN / 16;   // score columns per thread: tx + 16 * j
  constexpr int KR = BN / 16;   // keys per thread in dk and dv: ty * KR + i
  constexpr int PS = BN + 4;    // row stride of the shared score tiles
  extern __shared__ float smem[];
  float* ks = smem;                    // BN x kS
  float* vs = ks + BN * kS;            // BN x kS
  float* qs = vs + BN * kS;            // kBM x kS
  float* gs = qs + kBM * kS;           // kBM x kS
  float* ps = gs + kBM * kS;           // kBM x PS
  float* dss = ps + kBM * PS;          // kBM x PS
  float* lse_s = dss + kBM * PS;       // kBM
  float* delta_s = lse_s + kBM;        // kBM

  const int k0 = blockIdx.x * BN;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, HC, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * HC;
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;

  load_tile<HC, BN>(ks, base + off.k, c3, k0, n, tid);
  load_tile<HC, BN>(vs, base + off.v, c3, k0, n, tid);

  // this thread's keys are ty * KR + i, its channels tx + 16 * j
  float dk[KR][kOC], dv[KR][kOC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < n; q0 += kBM) {
    __syncthreads();  // the previous tile's readers are done with qs/gs/ps/dss
    load_tile<HC>(qs, base + off.q, c3, q0, n, tid);
    load_tile<HC>(gs, gbase, c, q0, n, tid);
    if (tid < kBM) {
      const int row = q0 + tid;
      lse_s[tid] = row < n ? lse[stat_base + row] : 0.f;
      delta_s[tid] = row < n ? delta[stat_base + row] : 0.f;
    }
    __syncthreads();

    // score tile: query rows ty * kTR + i, keys tx + 16 * j
    float s[kTR][TC], dp[kTR][TC];
    tile_dot_nt<HC, kTR, TC>(qs, ks, ty, tx, s);
    tile_dot_nt<HC, kTR, TC>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty * kTR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = tx + 16 * j;
        const bool valid = (q0 + r < n) && (k0 + col < n);
        const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ps[r * PS + col] = p;
        dss[r * PS + col] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dv += p^T g and dk += ds^T q over the tile's query rows
#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      float pk[KR], dsk[KR], gv[kOC], qv[kOC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pk[i] = ps[r * PS + ty * KR + i];
        dsk[i] = dss[r * PS + ty * KR + i];
      }
#pragma unroll
      for (int j = 0; j < kOC; ++j) {
        gv[j] = gs[r * kS + tx + 16 * j];
        qv[j] = qs[r * kS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) {
          dv[i][j] = fmaf(pk[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsk[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int key = k0 + ty * KR + i;
    if (key >= n) continue;
    float* dst = dqkv + ((size_t)b * n + key) * c3;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      dst[off.k + tx + 16 * j] = dk[i][j];
      dst[off.v + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int HC>
cudaError_t launch_f32(const float* qkv, const float* g, const float* o, const float* lse,
                       float* dqkv, float* delta, int batch, int n, int c, int num_heads,
                       int split_first, float scale, cudaStream_t stream) {
  constexpr int kOwn = own_rows<HC>();  // BM of the dq kernel, BN of the dk/dv kernel
  auto dq_kernel = attention_bwd_dq_kernel<HC, kOwn>;
  auto dkv_kernel = attention_bwd_dkv_kernel<HC, kOwn>;
  constexpr size_t dq_smem = dq_smem_bytes<HC, kOwn>();
  constexpr size_t dkv_smem = dkv_smem_bytes<HC, kOwn>();
  static_assert(dq_smem <= 232448 && dkv_smem <= 232448, "over a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kOwn - 1) / kOwn, num_heads, batch);
  dq_kernel<<<grid, kThreads, dq_smem, stream>>>(qkv, g, o, lse, dqkv, delta, n, c,
                                                 split_first, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem, stream>>>(qkv, g, lse, delta, dqkv, n, c,
                                                   split_first, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16, tensor cores

constexpr int kWgThreads = 128;     // one warpgroup: one 64-row tile
constexpr uint32_t kSbo = 8 * 128;  // 8 rows of 128 bytes: one swizzle atom

struct BwdArgs {
  const bf16* qkv;
  const bf16* g;
  const bf16* o;
  const float* lse;  // (B, H, N), natural log
  float* delta;      // (B, H, N) scratch: written by the dq kernel, read by dk/dv
  bf16* dqkv;
  int n, c, split_first;
  float scale;
};

template <int HC>
struct BwdTile {
  static constexpr int kWgs = HC <= 128 ? 2 : 1;  // warpgroups (own 64-row tiles) a block
  static constexpr int kThreads = kWgs * kWgThreads;
  static constexpr int kOwn = 64 * kWgs;           // rows a block owns
  static constexpr int kDP = HC < 64 ? 64 : HC;    // staged width: whole 128-byte rows
  static constexpr int kCB = kDP / 64;             // 64-column blocks
  static constexpr int kOwnBytes = kOwn * kDP * 2;  // one owned tile (Q or G; K or V)
  static constexpr int kTileBytes = 64 * kDP * 2;   // one streamed tile
  static constexpr bool kSplit = HC > 128;  // dk/dv: dV and dK in separate blocks
  static constexpr bool kSeq = HC > 128;    // dP issued once p is packed
  // two owned tiles, two stages of two streamed tiles, two stages of 64 lse
  // and 64 delta values (dk/dv), and room to align on 1024 bytes
  static constexpr size_t kSmem = 2 * kOwnBytes + 4 * kTileBytes + 2 * 128 * 4 + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// the 16 B row-stride offsets of a K-major operand: step kk (16 columns)
// starts 32 (kk % 4) bytes into the 128-byte rows of the 64-column block
// kk / 4 of a tile of `rows` rows
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return sm90::sw128_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, kSbo);
}

// an MN-major B operand of 64 rows (K) x 64 columns (N): rows 16 kk to
// 16 kk + 15 of the 64-column block cb
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int cb, int kk) {
  return sm90::sw128_desc(tile + cb * 64 * 128 + kk * 16 * 128, 64 * 128, kSbo);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// acc (+)= A B over HC / 16 steps, A (64 rows at a) and B (64 rows at b)
// both K-major; A's tile has a_rows rows
template <int HC>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HC / 16; ++kk)
    sm90::wgmma_ss_m64n64k16(acc, kmajor_desc(a, a_rows, kk), kmajor_desc(b, 64, kk), kk > 0);
}

// acc[cb] += A B: A the register fragments of a 64 x 64 tile, B 64 rows
// (MN-major) at b
template <int CB>
__device__ __forceinline__ void product_rs(float (&acc)[CB][32], const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      sm90::wgmma_rs_m64n64k16<1>(acc[cb], a[kk], mnmajor_desc(b, cb, kk), 1);
}

template <int CB>
__device__ __forceinline__ void fence_all(float (&acc)[CB][32]) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) sm90::fence_regs(acc[cb]);
}

// rows r and r + 8 of a warpgroup's 64 x (64 CB) f32 accumulator, rounded to
// bf16, into rows of device memory (row stride ld) at columns below HC;
// rows past n are not stored
template <int HC, int CB>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, int r, int n,
                                           const float (&acc)[CB][32], int col_lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= n) continue;
    bf16* d = dst + (size_t)row * ld;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + col_lane;
        if (col < HC)
          *reinterpret_cast<__nv_bfloat162*>(d + col) = __floats2bfloat162_rn(
              acc[cb][4 * j + 2 * half], acc[cb][4 * j + 2 * half + 1]);
      }
  }
}

// The accumulator element pairs (i, i + 1), i = 8 kk + 2 r, of a 64 x 64
// tile are row g + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2 (l % 4) + {0, 1}
// (sm90.cuh), and packed they are register r of the A fragment of step kk.

template <int HC>
__global__ void __launch_bounds__(BwdTile<HC>::kThreads, 1)
attention_bwd_dq_wgmma_kernel(const BwdArgs a) {
  using P = BwdTile<HC>;
  constexpr int kT = P::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + P::kOwnBytes;
  const uint32_t kv_s = g_s + P::kOwnBytes;  // stage s: K at + 2 s kT, V at + (2 s + 1) kT

  const int q0 = blockIdx.x * P::kOwn;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;  // owns query rows q0 + 64 wg to q0 + 64 wg + 63
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const int n = a.n, c = a.c, c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, HC, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * HC;
  const bf16* ob = a.o + (size_t)b * n * c + head * HC;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;

  using sm90::stage_tile;
  stage_tile<P::kOwn, P::kDP, P::kThreads>(q_s, base + off.q, c3, q0, n, HC, true, tid);
  stage_tile<P::kOwn, P::kDP, P::kThreads>(g_s, gb, c, q0, n, HC, true, tid);
  stage_tile<64, P::kDP, P::kThreads>(kv_s, base + off.k, c3, 0, n, HC, true, tid);
  stage_tile<64, P::kDP, P::kThreads>(kv_s + kT, base + off.v, c3, 0, n, HC, true, tid);
  sm90::cp_async_commit();

  // this thread's rows r0 and r0 + 8: their lse in log2 units, and delta =
  // rowsum(g o) from device memory, a quad of lanes to a row
  const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    float acc = 0.f;
    if (row < n) {
      const bf16* gr = gb + (size_t)row * c;
      const bf16* orow = ob + (size_t)row * c;
      for (int d = col_lane; d < HC; d += 8) {
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gr + d));
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
        acc = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[half] = acc;
    lse2[half] = row < n ? a.lse[stat + row] * kLog2e : 0.f;
    if (lane % 4 == 0 && row < n) a.delta[stat + row] = acc;
  }

  float dq[P::kCB][32];
#pragma unroll
  for (int cb = 0; cb < P::kCB; ++cb) zero(dq[cb]);

  const int tiles = (n + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    // tile t (and Q, G) landed in this thread's writes; the barrier makes
    // everyone's visible and tells that tile t - 1's stage is free
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    __syncthreads();
    // tile bases opaque to the compiler, so that it rebuilds each descriptor
    // where it is used instead of holding them across the loop
    uint32_t q_t = q_s + wg * 64 * 128, g_t = g_s + wg * 64 * 128;
    uint32_t k_t = kv_s + 2 * (t & 1) * kT;
    asm volatile("" : "+r"(q_t), "+r"(g_t), "+r"(k_t));
    const uint32_t v_t = k_t + kT;

    float s[32], dp[32];
    sm90::wgmma_fence();
    product_ss<HC>(s, q_t, P::kOwn, k_t);
    sm90::wgmma_commit();
    if constexpr (!P::kSeq) {
      product_ss<HC>(dp, g_t, P::kOwn, v_t);
      sm90::wgmma_commit();
    }
    // tile t + 1 loads into the other stage while S (and dP) multiply
    if (t + 1 < tiles) {
      const uint32_t next = kv_s + 2 * ((t + 1) & 1) * kT;
      stage_tile<64, P::kDP, P::kThreads>(next, base + off.k, c3, (t + 1) * 64, n, HC, true, tid);
      stage_tile<64, P::kDP, P::kThreads>(next + kT, base + off.v, c3, (t + 1) * 64, n, HC, true,
                                          tid);
      sm90::cp_async_commit();
    }
    if constexpr (P::kSeq) sm90::wgmma_wait<0>();
    else sm90::wgmma_wait<1>();
    sm90::fence_regs(s);

    // p = exp(scale s - lse), keys past n at 0, rounded to bf16 in pairs
    const int k0 = t * 64;
    const bool ragged = k0 + 64 > n;
    uint32_t pk[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, key = k0 + 16 * kk + 8 * (r / 2) + col_lane;
        float p0 = sm90::ex2(fmaf(s[i], scale_log2, -lse2[r % 2]));
        float p1 = sm90::ex2(fmaf(s[i + 1], scale_log2, -lse2[r % 2]));
        if (ragged) {
          if (key >= n) p0 = 0.f;
          if (key + 1 >= n) p1 = 0.f;
        }
        pk[kk][r] = sm90::pack_bf16x2(p0, p1);
      }
    if constexpr (P::kSeq) {
      sm90::wgmma_fence();
      product_ss<HC>(dp, g_t, P::kOwn, v_t);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);

    // ds = p (dp - delta) scale from the rounded p, rounded to bf16: the A
    // fragments of dQ += dS K
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float d = dlt[r % 2];
        ds[kk][r] = sm90::pack_bf16x2(sm90::bf16_lo(pk[kk][r]) * (dp[i] - d) * scale,
                                      sm90::bf16_hi(pk[kk][r]) * (dp[i + 1] - d) * scale);
      }
    fence_all(dq);
    sm90::wgmma_fence();
    product_rs(dq, ds, k_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(dq);
  }

  store_rows<HC>(a.dqkv + (size_t)b * n * c3 + off.q, c3, r0, n, dq, col_lane);
}

// One 64-key tile of a warpgroup: dV (kDV) and dK (kDK) over the query tiles.
template <int HC, bool kDV, bool kDK>
__device__ __forceinline__ void dkv_body(const BwdArgs& a, int key_tile) {
  using P = BwdTile<HC>;
  constexpr int kT = P::kTileBytes;
  constexpr bool kSeq = P::kSeq;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + P::kOwnBytes;
  const uint32_t qg_s = v_s + P::kOwnBytes;  // stage s: Q at + 2 s kT, G at + (2 s + 1) kT
  // stage s: lse * log2(e) of its 64 query rows at + 128 s, delta at + 128 s + 64
  float* stats = reinterpret_cast<float*>(smem_raw + (qg_s + 4 * kT - raw));

  const int k0 = key_tile * P::kOwn;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;  // owns keys k0 + 64 wg to k0 + 64 wg + 63
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const int n = a.n, c = a.c, c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, HC, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * HC;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;
  const int col_lane = 2 * (lane % 4);
  const float scale = a.scale, scale_log2 = scale * kLog2e;

  // the query tile at q0 into stage st: Q, G (cp.async) and its lse and
  // delta (plain loads and stores; rows past n get lse = inf, so p = 0)
  auto stage_queries = [&](int st, int q0) {
    const uint32_t at = qg_s + 2 * st * kT;
    sm90::stage_tile<64, P::kDP, P::kThreads>(at, base + off.q, c3, q0, n, HC, true, tid);
    sm90::stage_tile<64, P::kDP, P::kThreads>(at + kT, gb, c, q0, n, HC, true, tid);
    sm90::cp_async_commit();
    for (int i = tid; i < 128; i += P::kThreads) {
      const int row = q0 + i % 64;
      float v;
      if (i < 64) v = row < n ? a.lse[stat + row] * kLog2e : __int_as_float(0x7f800000);
      else v = row < n ? a.delta[stat + row] : 0.f;
      stats[128 * st + i] = v;
    }
  };

  sm90::stage_tile<P::kOwn, P::kDP, P::kThreads>(k_s, base + off.k, c3, k0, n, HC, true, tid);
  if constexpr (kDK)
    sm90::stage_tile<P::kOwn, P::kDP, P::kThreads>(v_s, base + off.v, c3, k0, n, HC, true, tid);
  stage_queries(0, 0);

  float dv[kDV ? P::kCB : 1][32], dk[kDK ? P::kCB : 1][32];
#pragma unroll
  for (int cb = 0; cb < P::kCB; ++cb) {
    if constexpr (kDV) zero(dv[cb]);
    if constexpr (kDK) zero(dk[cb]);
  }

  const int tiles = (n + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    __syncthreads();
    uint32_t k_t = k_s + wg * 64 * 128, v_t = v_s + wg * 64 * 128;
    uint32_t q_t = qg_s + 2 * (t & 1) * kT;
    asm volatile("" : "+r"(k_t), "+r"(v_t), "+r"(q_t));
    const uint32_t g_t = q_t + kT;
    const float* lse2 = stats + 128 * (t & 1);
    const float* dlt = lse2 + 64;

    // S^T = K Q^T and dP^T = V G^T: keys as rows, queries as columns
    float s[32], dp[32];
    sm90::wgmma_fence();
    product_ss<HC>(s, k_t, P::kOwn, q_t);
    sm90::wgmma_commit();
    if constexpr (kDK && !kSeq) {
      product_ss<HC>(dp, v_t, P::kOwn, g_t);
      sm90::wgmma_commit();
    }
    if (t + 1 < tiles) stage_queries((t + 1) & 1, (t + 1) * 64);
    if constexpr (kDK && !kSeq) sm90::wgmma_wait<1>();
    else sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // p^T = exp(scale s - lse[query]), rounded to bf16 in pairs: the A
    // fragments of dV += P^T G
    uint32_t pk[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
        pk[kk][r] = sm90::pack_bf16x2(sm90::ex2(fmaf(s[i], scale_log2, -l2.x)),
                                      sm90::ex2(fmaf(s[i + 1], scale_log2, -l2.y)));
      }
    uint32_t ds[4][4];
    if constexpr (kDK) {
      if constexpr (kSeq) {
        sm90::wgmma_fence();
        product_ss<HC>(dp, v_t, P::kOwn, g_t);
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      // ds^T = p^T (dp^T - delta[query]) scale, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
          const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
          ds[kk][r] = sm90::pack_bf16x2(sm90::bf16_lo(pk[kk][r]) * (dp[i] - d2.x) * scale,
                                        sm90::bf16_hi(pk[kk][r]) * (dp[i + 1] - d2.y) * scale);
        }
    }
    if constexpr (kDV) fence_all(dv);
    if constexpr (kDK) fence_all(dk);
    sm90::wgmma_fence();
    if constexpr (kDV) product_rs(dv, pk, g_t);
    if constexpr (kDK) product_rs(dk, ds, q_t);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    if constexpr (kDV) fence_all(dv);
    if constexpr (kDK) fence_all(dk);
  }

  const int r0 = k0 + 64 * wg + 16 * warp + lane / 4;
  bf16* dst = a.dqkv + (size_t)b * n * c3;
  if constexpr (kDK) store_rows<HC>(dst + off.k, c3, r0, n, dk, col_lane);
  if constexpr (kDV) store_rows<HC>(dst + off.v, c3, r0, n, dv, col_lane);
}

// dk and dv; with BwdTile::kSplit, the even x indices of a key tile make dV
// and the odd ones dK
template <int HC>
__global__ void __launch_bounds__(BwdTile<HC>::kThreads, 1)
attention_bwd_dkv_wgmma_kernel(const BwdArgs a) {
  if constexpr (BwdTile<HC>::kSplit) {
    if (blockIdx.x & 1) dkv_body<HC, false, true>(a, blockIdx.x >> 1);
    else dkv_body<HC, true, false>(a, blockIdx.x >> 1);
  } else {
    dkv_body<HC, true, true>(a, blockIdx.x);
  }
}

template <int HC>
cudaError_t launch_bf16(const BwdArgs& a, int batch, int num_heads, cudaStream_t stream) {
  using P = BwdTile<HC>;
  auto dq_kernel = attention_bwd_dq_wgmma_kernel<HC>;
  auto dkv_kernel = attention_bwd_dkv_wgmma_kernel<HC>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  const int own = (a.n + P::kOwn - 1) / P::kOwn;
  dq_kernel<<<dim3(own, num_heads, batch), P::kThreads, P::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(own * (P::kSplit ? 2 : 1), num_heads, batch), P::kThreads, P::kSmem,
               stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). qkv and dqkv
// are (batch, n, 3c), g and o (batch, n, c), lse the f32 (batch, num_heads,
// n) row log-sum-exp K1 wrote (natural log), delta f32 (batch, num_heads, n)
// scratch; all contiguous on the current device, and for bf16 qkv and g on
// 16 bytes, o and dqkv on 4. Returns the CUDA error code of the launches (0
// on success).
int nd_fused_qkv_attention_bwd_lse(const void* qkv, const void* g, const void* o,
                                   const void* lse, void* dqkv, void* delta, int batch, int n,
                                   int c, int num_heads, int split_first, int dtype, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n <= 0 || num_heads <= 0 || c % num_heads != 0)
    return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0) {
    const float* q = static_cast<const float*>(qkv);
    const float* gf = static_cast<const float*>(g);
    const float* of = static_cast<const float*>(o);
    float* d = static_cast<float*>(dqkv);
#define ND_LAUNCH(HC)                                                                     \
  return (int)launch_f32<HC>(q, gf, of, lse_f, d, delta_f, batch, n, c, num_heads,        \
                             split_first, scale, s)
    switch (c / num_heads) {
      case 32: ND_LAUNCH(32);
      case 64: ND_LAUNCH(64);
      case 128: ND_LAUNCH(128);
      case 192: ND_LAUNCH(192);
      case 256: ND_LAUNCH(256);
      default: return (int)cudaErrorInvalidValue;
    }
#undef ND_LAUNCH
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!aligned(qkv, 16) || !aligned(g, 16) || !aligned(o, 4) || !aligned(dqkv, 4))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a = {static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
                     static_cast<const bf16*>(o), lse_f, delta_f, static_cast<bf16*>(dqkv),
                     n, c, split_first, scale};
  switch (c / num_heads) {
    case 32: return (int)launch_bf16<32>(a, batch, num_heads, s);
    case 64: return (int)launch_bf16<64>(a, batch, num_heads, s);
    case 128: return (int)launch_bf16<128>(a, batch, num_heads, s);
    case 192: return (int)launch_bf16<192>(a, batch, num_heads, s);
    case 256: return (int)launch_bf16<256>(a, batch, num_heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
