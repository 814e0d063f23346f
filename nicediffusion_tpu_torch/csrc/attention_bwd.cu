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
//
// Head dims. Each kernel is built for HC = 32, 64, 128, 192 and 256 and runs
// any head dim D up to HC: q, k, v, g and o land zero past D and nothing
// past D is stored. Every build has two instances: the exact one (D = HC,
// and in bf16 rows that allow 16-byte copies) folds D to the constant HC,
// as the kernels were before other head dims ran, and the other reads D at
// run time and masks its loads and stores.
//
// Head dims above 256: K1's two routes (attention.cu, attention_chunked.cuh),
// chosen by the same plan from N and D.
//   * The P-resident route (bf16, N <= 1152): two kernels, no atomics.
//     attention_bwd_delta_kernel makes delta = rowsum(g o) a row (a quad of
//     lanes a row, the walk's order of sums); then
//     attention_bwd_resident_wgmma_kernel runs three kinds of block, each
//     owning one 64-row tile: dq (query tile: pass 1 makes S_t and dP_t once
//     a key tile, p from K1's lse, keeps dS_t in shared memory; pass 2 walks
//     dQ's 64-column blocks, dQ += dS_t K_t), dk (key tile: S^T and dP^T
//     once a query tile, dS^T kept; dK += dS^T_t Q_t) and dv (key tile: S^T
//     once a query tile, P^T kept; dV += P^T_t G_t). The query rows' lse and
//     delta of dk and dv sit in shared memory (512 bytes a tile). Per (query
//     tile, key tile) pair: S three times, dP twice, dQ, dK and dV once: 8
//     of the 5 products the function needs, 1.6x (a split over s blocks: (5 s
//     + 3) / 5). One launch of 3 x tiles x split blocks a head. Shared
//     memory as K1's route; ptxas (CUDA 12.8): 168 registers (consumers 224,
//     producer 56 by setmaxnreg), no spill; the delta kernel 30.
//   * The walk (bf16 above N = 1152, f32 always; the kernels below): a
//     grid axis over chunks of the output's columns; every contraction over
//     D (S and dP, or S^T and dP^T) is summed over 64-column chunks streamed
//     through a two-stage ring, and a block accumulates only its chunk of dQ,
//     dK or dV. bf16 dq (attention_bwd_dq_chunked_wgmma_kernel: a 64-row
//     query tile and 256 dQ columns; delta over the whole row by every block,
//     chunk 0 writes it) 244 registers; dk/dv (attention_bwd_dkv_chunked_
//     wgmma_kernel: (key tile, chunk, dV or dK)) 240; both 67,072 bytes. f32
//     (attention_bwd_dq_chunked_kernel, attention_bwd_dkv_chunked_kernel): the
//     FMA kernels' tiles, four operands restaged a chunk at a time, 128
//     columns (one block makes dK and dV); 116,992 and 167,936 bytes, 128 and
//     184 registers. The price is S and dP made once per output chunk:
//     (5 ceil(D / 256) + 3) / 5 of the products in bf16, 2.6x at D = 512, 4.6x
//     at 1024.
// Both bf16 routes give the same bits: every S, p, dP, dS and output element
// from the same sums in the same order with the same roundings. What bounds
// them on this card: 5 x 2 N^2 D flops a head against 8 N D bytes, the
// tensor cores at the training shapes.

#include "attention_chunked.cuh"
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

// rows [row0, row0 + ROWS) of one head's dv channels -> a shared tile of row
// stride HC + 1, zero past row n and past column dv
template <int HC, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t row_stride,
                                          int row0, int n, int dv, int tid) {
  for (int i = tid; i < ROWS * HC; i += kThreads) {
    const int r = i / HC, d = i % HC, row = row0 + r;
    dst[r * (HC + 1) + d] = row < n && d < dv ? src[(size_t)row * row_stride + d] : 0.f;
  }
}

// EXACT: the head dim is HC, so dv folds to it and no column is masked
template <int HC, int BM, bool EXACT>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                        const float* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ dqkv, float* __restrict__ delta, int n, int c,
                        int head_dim, int split_first, float scale) {
  const int dv = EXACT ? HC : head_dim;
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
  const QkvOffsets off = qkv_offsets(head, dv, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * dv;
  const float* obase = o + (size_t)b * n * c + head * dv;

  load_tile<HC, BM>(qs, base + off.q, c3, q0, n, dv, tid);
  load_tile<HC, BM>(gs, gbase, c, q0, n, dv, tid);
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
        if (d < dv) acc = fmaf(gs[r * kS + d], obase[(size_t)row * c + d], acc);
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
    load_tile<HC>(ks, base + off.k, c3, k0, n, dv, tid);
    load_tile<HC>(vs, base + off.v, c3, k0, n, dv, tid);
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
    for (int j = 0; j < kOC; ++j)
      if (tx + 16 * j < dv) dst[tx + 16 * j] = dq[i][j];
  }
}

template <int HC, int BN, bool EXACT>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dqkv, int n, int c, int head_dim, int split_first,
                         float scale) {
  const int dv = EXACT ? HC : head_dim;
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
  const QkvOffsets off = qkv_offsets(head, dv, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * dv;
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;

  load_tile<HC, BN>(ks, base + off.k, c3, k0, n, dv, tid);
  load_tile<HC, BN>(vs, base + off.v, c3, k0, n, dv, tid);

  // this thread's keys are ty * KR + i, its channels tx + 16 * j
  float dk[KR][kOC], dv_acc[KR][kOC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      dk[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < n; q0 += kBM) {
    __syncthreads();  // the previous tile's readers are done with qs/gs/ps/dss
    load_tile<HC>(qs, base + off.q, c3, q0, n, dv, tid);
    load_tile<HC>(gs, gbase, c, q0, n, dv, tid);
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
          dv_acc[i][j] = fmaf(pk[i], gv[j], dv_acc[i][j]);
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
      if (tx + 16 * j >= dv) continue;
      dst[off.k + tx + 16 * j] = dk[i][j];
      dst[off.v + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int HC, bool EXACT>
cudaError_t launch_f32(const float* qkv, const float* g, const float* o, const float* lse,
                       float* dqkv, float* delta, int batch, int n, int c, int num_heads,
                       int dv, int split_first, float scale, cudaStream_t stream) {
  constexpr int kOwn = own_rows<HC>();  // BM of the dq kernel, BN of the dk/dv kernel
  auto dq_kernel = attention_bwd_dq_kernel<HC, kOwn, EXACT>;
  auto dkv_kernel = attention_bwd_dkv_kernel<HC, kOwn, EXACT>;
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
  dq_kernel<<<grid, kThreads, dq_smem, stream>>>(qkv, g, o, lse, dqkv, delta, n, c, dv,
                                                 split_first, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem, stream>>>(qkv, g, lse, delta, dqkv, n, c, dv,
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
  int d;      // the head dim, at most HC: columns past it are zeros and not stored
  int vec16;  // q, k, v and g allow 16-byte copies (d and c multiples of 8)
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
// bf16, into rows of device memory (row stride ld, 3c) at columns below dv
// (in pairs where dv, and so c and ld, are even); rows past n are not stored
template <int CB>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld, int r, int n, int dv,
                                           const float (&acc)[CB][32], int col_lane) {
  const bool pairs = dv % 2 == 0;
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
        const float v0 = acc[cb][4 * j + 2 * half], v1 = acc[cb][4 * j + 2 * half + 1];
        if (pairs && col < dv) {
          *reinterpret_cast<__nv_bfloat162*>(d + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < dv) d[col] = __float2bfloat16(v0);
          if (col + 1 < dv) d[col + 1] = __float2bfloat16(v1);
        }
      }
  }
}

// The accumulator element pairs (i, i + 1), i = 8 kk + 2 r, of a 64 x 64
// tile are row g + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2 (l % 4) + {0, 1}
// (sm90.cuh), and packed they are register r of the A fragment of step kk.

// EXACT: the head dim is HC and q, k, v, g and o allow 16-byte (o 4-byte)
// loads, so dv and vec fold to constants and no column is masked
template <int HC, bool EXACT>
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
  const int n = a.n, c = a.c, c3 = 3 * c, dv = EXACT ? HC : a.d;
  const bool vec = EXACT || a.vec16;
  const QkvOffsets off = qkv_offsets(head, dv, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * dv;
  const bf16* ob = a.o + (size_t)b * n * c + head * dv;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;

  using sm90::stage_tile;
  stage_tile<P::kOwn, P::kDP, P::kThreads>(q_s, base + off.q, c3, q0, n, dv, vec, tid);
  stage_tile<P::kOwn, P::kDP, P::kThreads>(g_s, gb, c, q0, n, dv, vec, tid);
  stage_tile<64, P::kDP, P::kThreads>(kv_s, base + off.k, c3, 0, n, dv, vec, tid);
  stage_tile<64, P::kDP, P::kThreads>(kv_s + kT, base + off.v, c3, 0, n, dv, vec, tid);
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
      if constexpr (EXACT) {
        for (int d = col_lane; d < HC; d += 8) {
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gr + d));
          const float2 ov =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
          acc = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, acc));
        }
      } else {
        for (int d = col_lane; d < dv; d += 8) {
          const float g1 = d + 1 < dv ? __bfloat162float(gr[d + 1]) : 0.f;
          const float o1 = d + 1 < dv ? __bfloat162float(orow[d + 1]) : 0.f;
          acc = fmaf(__bfloat162float(gr[d]), __bfloat162float(orow[d]), fmaf(g1, o1, acc));
        }
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
      stage_tile<64, P::kDP, P::kThreads>(next, base + off.k, c3, (t + 1) * 64, n, dv, vec, tid);
      stage_tile<64, P::kDP, P::kThreads>(next + kT, base + off.v, c3, (t + 1) * 64, n, dv, vec,
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

  store_rows(a.dqkv + (size_t)b * n * c3 + off.q, c3, r0, n, dv, dq, col_lane);
}

// One 64-key tile of a warpgroup: dV (kDV) and dK (kDK) over the query tiles.
template <int HC, bool EXACT, bool kDV, bool kDK>
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
  const int n = a.n, c = a.c, c3 = 3 * c, hd = EXACT ? HC : a.d;
  const bool vec = EXACT || a.vec16;
  const QkvOffsets off = qkv_offsets(head, hd, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * hd;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;
  const int col_lane = 2 * (lane % 4);
  const float scale = a.scale, scale_log2 = scale * kLog2e;

  // the query tile at q0 into stage st: Q, G (cp.async) and its lse and
  // delta (plain loads and stores; rows past n get lse = inf, so p = 0)
  auto stage_queries = [&](int st, int q0) {
    const uint32_t at = qg_s + 2 * st * kT;
    sm90::stage_tile<64, P::kDP, P::kThreads>(at, base + off.q, c3, q0, n, hd, vec, tid);
    sm90::stage_tile<64, P::kDP, P::kThreads>(at + kT, gb, c, q0, n, hd, vec, tid);
    sm90::cp_async_commit();
    for (int i = tid; i < 128; i += P::kThreads) {
      const int row = q0 + i % 64;
      float v;
      if (i < 64) v = row < n ? a.lse[stat + row] * kLog2e : __int_as_float(0x7f800000);
      else v = row < n ? a.delta[stat + row] : 0.f;
      stats[128 * st + i] = v;
    }
  };

  sm90::stage_tile<P::kOwn, P::kDP, P::kThreads>(k_s, base + off.k, c3, k0, n, hd, vec, tid);
  if constexpr (kDK)
    sm90::stage_tile<P::kOwn, P::kDP, P::kThreads>(v_s, base + off.v, c3, k0, n, hd, vec, tid);
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
  if constexpr (kDK) store_rows(dst + off.k, c3, r0, n, hd, dk, col_lane);
  if constexpr (kDV) store_rows(dst + off.v, c3, r0, n, hd, dv, col_lane);
}

// dk and dv; with BwdTile::kSplit, the even x indices of a key tile make dV
// and the odd ones dK
template <int HC, bool EXACT>
__global__ void __launch_bounds__(BwdTile<HC>::kThreads, 1)
attention_bwd_dkv_wgmma_kernel(const BwdArgs a) {
  if constexpr (BwdTile<HC>::kSplit) {
    if (blockIdx.x & 1) dkv_body<HC, EXACT, false, true>(a, blockIdx.x >> 1);
    else dkv_body<HC, EXACT, true, false>(a, blockIdx.x >> 1);
  } else {
    dkv_body<HC, EXACT, true, true>(a, blockIdx.x);
  }
}

template <int HC, bool EXACT>
cudaError_t launch_bf16(const BwdArgs& a, int batch, int num_heads, cudaStream_t stream) {
  using P = BwdTile<HC>;
  auto dq_kernel = attention_bwd_dq_wgmma_kernel<HC, EXACT>;
  auto dkv_kernel = attention_bwd_dkv_wgmma_kernel<HC, EXACT>;
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

// ------------------------------------------ head dims above 256: D in chunks

// Output columns a block (a chunk of D): dQ, dK or dV of a 64-row tile is
// DC / 2 registers a thread in bf16, as at the build for 256. The f32 dk/dv
// block holds both sums and their two operand tiles, hence its narrower chunk.
constexpr int kChunkBf16 = 256;
constexpr int kChunkF32 = 128;

template <int DC>
struct ChunkedBwdTile {
  static constexpr int kRing = chunked::Ring<64>::kBytes;  // the contractions' chunks
  static constexpr int kOutBytes = 64 * DC * 2;            // the output product's B operand
  // the ring, the B operand, 64 lse and 64 delta values (dk/dv), alignment
  static constexpr size_t kSmem = kRing + kOutBytes + 128 * 4 + 1024;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// bf16 dq at D > 256: one warpgroup a block of (query tile, dQ column chunk).
// S = Q K^T and then dP = G V^T are summed over 64-column chunks of D
// (chunked::contract; S is packed to p before dP is made, so the two are
// never live together), delta = rowsum(g o) over the whole head row from
// device memory by every block (chunk 0 writes it for the dk/dv kernel), and
// dQ's DC columns accumulate dS K[:, chunk]. Rounding as the dq kernel above.
template <int DC>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_dq_chunked_wgmma_kernel(const BwdArgs a) {
  using P = ChunkedBwdTile<DC>;
  constexpr int kCB = DC / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_s = ring + P::kRing;

  const int n = a.n, c = a.c, c3 = 3 * c, dv = a.d;
  const int chunks = (dv + DC - 1) / DC;
  const int q0 = (blockIdx.x / chunks) * 64;
  const int d0 = (blockIdx.x % chunks) * DC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bool vec = a.vec16;
  const QkvOffsets off = qkv_offsets(head, dv, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * dv;
  const bf16* ob = a.o + (size_t)b * n * c + head * dv;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;

  // this thread's rows r0 and r0 + 8: their lse in log2 units and delta
  const int r0 = q0 + 16 * warp + lane / 4;
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
      for (int d = col_lane; d < dv; d += 8) {
        const float g1 = d + 1 < dv ? __bfloat162float(gr[d + 1]) : 0.f;
        const float o1 = d + 1 < dv ? __bfloat162float(orow[d + 1]) : 0.f;
        acc = fmaf(__bfloat162float(gr[d]), __bfloat162float(orow[d]), fmaf(g1, o1, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[half] = acc;
    lse2[half] = row < n ? a.lse[stat + row] * kLog2e : 0.f;
    if (d0 == 0 && lane % 4 == 0 && row < n) a.delta[stat + row] = acc;
  }

  float dq[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) zero(dq[cb]);

  int step = 0;
  const int tiles = (n + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * 64;
    float s[32];
    chunked::contract<64, kWgThreads>(
        s, ring, step, base + off.q, c3, q0, base + off.k, c3, k0, n, dv, vec, tid, 0, [&] {
          sm90::stage_tile<64, DC, kWgThreads>(out_s, base + off.k + d0, c3, k0, n, dv - d0, vec,
                                               tid);
        });
    // p = exp(scale s - lse), keys past n at 0, rounded to bf16 in pairs
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
    float dp[32];
    chunked::contract<64, kWgThreads>(dp, ring, step, gb, c, q0, base + off.v, c3, k0, n, dv,
                                      vec, tid, 0, [] {});
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
    product_rs(dq, ds, out_s);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(dq);
  }

  store_rows(a.dqkv + (size_t)b * n * c3 + off.q + d0, c3, r0, n, dv - d0, dq, col_lane);
}

// bf16 dk/dv at D > 256: one warpgroup a block of (key tile, dV or dK, column
// chunk). S^T = K Q^T (and for dK dP^T = V G^T) summed over 64-column chunks
// of D, then dV's DC columns accumulate P^T G[:, chunk], or dK's dS^T
// Q[:, chunk]. The query tile's lse and delta are staged with its B operand.
template <int DC>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_dkv_chunked_wgmma_kernel(const BwdArgs a) {
  using P = ChunkedBwdTile<DC>;
  constexpr int kCB = DC / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t out_s = ring + P::kRing;
  // lse * log2(e) of the query tile's 64 rows, then their delta
  float* stats = reinterpret_cast<float*>(smem_raw + (out_s + P::kOutBytes - raw));

  const int n = a.n, c = a.c, c3 = 3 * c, hd = a.d;
  const int chunks = (hd + DC - 1) / DC;
  const bool is_dk = blockIdx.x & 1;
  const int k0 = (blockIdx.x / 2 / chunks) * 64;
  const int d0 = (blockIdx.x / 2 % chunks) * DC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bool vec = a.vec16;
  const QkvOffsets off = qkv_offsets(head, hd, c, a.split_first);
  const bf16* base = a.qkv + (size_t)b * n * c3;
  const bf16* gb = a.g + (size_t)b * n * c + head * hd;
  const size_t stat = ((size_t)b * gridDim.y + head) * n;
  const int col_lane = 2 * (lane % 4);
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  // the B operand of this block's product: G's chunk for dV, Q's for dK
  const bf16* out_src = is_dk ? base + off.q + d0 : gb + d0;
  const long long out_ld = is_dk ? c3 : c;

  float acc[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb) zero(acc[cb]);

  int step = 0;
  const int tiles = (n + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    const int q0 = t * 64;
    float s[32];
    chunked::contract<64, kWgThreads>(
        s, ring, step, base + off.k, c3, k0, base + off.q, c3, q0, n, hd, vec, tid, 0, [&] {
          sm90::stage_tile<64, DC, kWgThreads>(out_s, out_src, out_ld, q0, n, hd - d0, vec, tid);
          // rows past n get lse = inf, so p = 0
          for (int i = tid; i < 128; i += kWgThreads) {
            const int row = q0 + i % 64;
            float v;
            if (i < 64) v = row < n ? a.lse[stat + row] * kLog2e : __int_as_float(0x7f800000);
            else v = row < n ? a.delta[stat + row] : 0.f;
            stats[i] = v;
          }
        });
    // p^T = exp(scale s - lse[query]), rounded to bf16 in pairs
    uint32_t pk[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
        const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
        pk[kk][r] = sm90::pack_bf16x2(sm90::ex2(fmaf(s[i], scale_log2, -l2.x)),
                                      sm90::ex2(fmaf(s[i + 1], scale_log2, -l2.y)));
      }
    if (is_dk) {
      float dp[32];
      chunked::contract<64, kWgThreads>(dp, ring, step, base + off.v, c3, k0, gb, c, q0, n, hd,
                                        vec, tid, 0, [] {});
      // ds^T = p^T (dp^T - delta[query]) scale, rounded to bf16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
          const float2 d2 = *reinterpret_cast<const float2*>(stats + 64 + col);
          pk[kk][r] = sm90::pack_bf16x2(sm90::bf16_lo(pk[kk][r]) * (dp[i] - d2.x) * scale,
                                        sm90::bf16_hi(pk[kk][r]) * (dp[i + 1] - d2.y) * scale);
        }
    }
    fence_all(acc);
    sm90::wgmma_fence();
    product_rs(acc, pk, out_s);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_all(acc);
  }

  const int r0 = k0 + 16 * warp + lane / 4;
  bf16* dst = a.dqkv + (size_t)b * n * c3 + (is_dk ? off.k : off.v) + d0;
  store_rows(dst, c3, r0, n, hd - d0, acc, col_lane);
}

template <int DC>
constexpr size_t chunked_dq_smem_bytes() {
  constexpr int kS = chunked::kCols + 1;
  return sizeof(float) * (size_t)(4 * 64 * kS + 64 * kPStride + 64 * (DC + 1));
}

template <int DC>
constexpr size_t chunked_dkv_smem_bytes() {
  constexpr int kS = chunked::kCols + 1;
  return sizeof(float) *
         (size_t)(4 * 64 * kS + 2 * 64 * kPStride + 2 * 64 * (DC + 1) + 2 * 64);
}

// f32 dq at D > 256: attention_bwd_dq_kernel with 64-row tiles, S and dP
// summed over 64-column chunks of q, k, g and v (restaged for every key
// tile), delta from device memory, and dq's DC columns from k's chunk.
template <int DC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_chunked_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                                const float* __restrict__ o, const float* __restrict__ lse,
                                float* __restrict__ dqkv, float* __restrict__ delta, int n, int c,
                                int dv, int split_first, float scale) {
  constexpr int kS = chunked::kCols + 1;
  constexpr int kOC = DC / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // 64 x kS: the chunks of the contractions
  float* gs = qs + 64 * kS;
  float* ks = gs + 64 * kS;
  float* vs = ks + 64 * kS;
  float* dss = vs + 64 * kS;    // 64 x kPStride
  float* kout = dss + 64 * kPStride;  // 64 x (DC + 1): k's columns d0 to d0 + DC - 1

  const int chunks = (dv + DC - 1) / DC;
  const int q0 = (blockIdx.x / chunks) * 64;
  const int d0 = (blockIdx.x % chunks) * DC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, dv, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * dv;
  const float* obase = o + (size_t)b * n * c + head * dv;
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;

  // the log-sum-exp of this thread's rows, and delta = rowsum(g * o) over
  // the whole head row from device memory
  float row_lse[kTR], row_delta[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = q0 + ty * kTR + i;
    row_lse[i] = row < n ? lse[stat_base + row] : 0.f;
    float acc = 0.f;
    if (row < n)
      for (int d = tx; d < dv; d += 16)
        acc = fmaf(gbase[(size_t)row * c + d], obase[(size_t)row * c + d], acc);
    row_delta[i] = row_sum16(acc);
    if (d0 == 0 && tx == 0 && row < n) delta[stat_base + row] = row_delta[i];
  }

  float dq[kTR][kOC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBN) {
    float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < dv; c0 += chunked::kCols) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      load_tile<chunked::kCols>(qs, base + off.q + c0, c3, q0, n, dv - c0, tid);
      load_tile<chunked::kCols>(gs, gbase + c0, c, q0, n, dv - c0, tid);
      load_tile<chunked::kCols>(ks, base + off.k + c0, c3, k0, n, dv - c0, tid);
      load_tile<chunked::kCols>(vs, base + off.v + c0, c3, k0, n, dv - c0, tid);
      if (c0 == 0) load_tile<DC>(kout, base + off.k + d0, c3, k0, n, dv - d0, tid);
      __syncthreads();
      tile_dot_nt_add(qs, ks, ty, tx, s);
      tile_dot_nt_add(gs, vs, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const bool valid = k0 + tx + 16 * j < n;
        const float p = valid ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty * kTR + i) * kPStride + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBN; ++k) {
      float dsv[kTR], kv[kOC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) dsv[i] = dss[(ty * kTR + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOC; ++j) kv[j] = kout[k * (DC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = q0 + ty * kTR + i;
    if (row >= n) continue;
    float* dst = dqkv + ((size_t)b * n + row) * c3 + off.q;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < dv) dst[d] = dq[i][j];
    }
  }
}

// f32 dk/dv at D > 256: attention_bwd_dkv_kernel with 64-key tiles, S and dP
// summed over 64-column chunks, dk's and dv's DC columns from q's and g's
// chunks.
template <int DC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_chunked_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dqkv, int n, int c, int dv, int split_first,
                                 float scale) {
  constexpr int kS = chunked::kCols + 1;
  constexpr int kO = DC + 1;    // row stride of the q and g column chunks
  constexpr int kOC = DC / 16;  // dk and dv columns per thread
  constexpr int KR = kBN / 16;  // keys per thread in dk and dv: ty * KR + i
  extern __shared__ float smem[];
  float* ks = smem;                  // 64 x kS each: the chunks of the contractions
  float* vs = ks + 64 * kS;
  float* qs = vs + 64 * kS;
  float* gs = qs + 64 * kS;
  float* ps = gs + 64 * kS;          // kBM x kPStride
  float* dss = ps + kBM * kPStride;  // kBM x kPStride
  float* qout = dss + kBM * kPStride;  // kBM x kO: q's columns d0 to d0 + DC - 1
  float* gout = qout + kBM * kO;       // kBM x kO: g's
  float* lse_s = gout + kBM * kO;      // kBM
  float* delta_s = lse_s + kBM;        // kBM

  const int chunks = (dv + DC - 1) / DC;
  const int k0 = (blockIdx.x / chunks) * kBN;
  const int d0 = (blockIdx.x % chunks) * DC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c3 = 3 * c;
  const QkvOffsets off = qkv_offsets(head, dv, c, split_first);
  const float* base = qkv + (size_t)b * n * c3;
  const float* gbase = g + (size_t)b * n * c + head * dv;
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;

  float dk[KR][kOC], dv_acc[KR][kOC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      dk[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < n; q0 += kBM) {
    // score tile: query rows ty * kTR + i, keys tx + 16 * j
    float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < dv; c0 += chunked::kCols) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      load_tile<chunked::kCols>(ks, base + off.k + c0, c3, k0, n, dv - c0, tid);
      load_tile<chunked::kCols>(vs, base + off.v + c0, c3, k0, n, dv - c0, tid);
      load_tile<chunked::kCols>(qs, base + off.q + c0, c3, q0, n, dv - c0, tid);
      load_tile<chunked::kCols>(gs, gbase + c0, c, q0, n, dv - c0, tid);
      if (c0 == 0) {
        load_tile<DC>(qout, base + off.q + d0, c3, q0, n, dv - d0, tid);
        load_tile<DC>(gout, gbase + d0, c, q0, n, dv - d0, tid);
        if (tid < kBM) {
          const int row = q0 + tid;
          lse_s[tid] = row < n ? lse[stat_base + row] : 0.f;
          delta_s[tid] = row < n ? delta[stat_base + row] : 0.f;
        }
      }
      __syncthreads();
      tile_dot_nt_add(qs, ks, ty, tx, s);
      tile_dot_nt_add(gs, vs, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty * kTR + i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int col = tx + 16 * j;
        const bool valid = (q0 + r < n) && (k0 + col < n);
        const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ps[r * kPStride + col] = p;
        dss[r * kPStride + col] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dv += p^T g and dk += ds^T q over the tile's query rows
#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      float pk[KR], dsk[KR], gv[kOC], qv[kOC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pk[i] = ps[r * kPStride + ty * KR + i];
        dsk[i] = dss[r * kPStride + ty * KR + i];
      }
#pragma unroll
      for (int j = 0; j < kOC; ++j) {
        gv[j] = gout[r * kO + tx + 16 * j];
        qv[j] = qout[r * kO + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) {
          dv_acc[i][j] = fmaf(pk[i], gv[j], dv_acc[i][j]);
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
      const int d = d0 + tx + 16 * j;
      if (d >= dv) continue;
      dst[off.k + d] = dk[i][j];
      dst[off.v + d] = dv_acc[i][j];
    }
  }
}

// grid x: dq (query tile * chunks + chunk); dk/dv bf16 ((key tile * chunks +
// chunk) * 2 + {0: dV, 1: dK}), f32 (key tile * chunks + chunk)
cudaError_t launch_chunked_f32(const float* qkv, const float* g, const float* o,
                               const float* lse, float* dqkv, float* delta, int batch, int n,
                               int c, int num_heads, int dv, int split_first, float scale,
                               cudaStream_t stream) {
  constexpr int kDC = kChunkF32;
  auto dq_kernel = attention_bwd_dq_chunked_kernel<kDC>;
  auto dkv_kernel = attention_bwd_dkv_chunked_kernel<kDC>;
  constexpr size_t dq_smem = chunked_dq_smem_bytes<kDC>();
  constexpr size_t dkv_smem = chunked_dkv_smem_bytes<kDC>();
  static_assert(dq_smem <= 232448 && dkv_smem <= 232448, "over a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  const int chunks = (dv + kDC - 1) / kDC;
  dim3 grid((n + 63) / 64 * chunks, num_heads, batch);
  dq_kernel<<<grid, kThreads, dq_smem, stream>>>(qkv, g, o, lse, dqkv, delta, n, c, dv,
                                                 split_first, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem, stream>>>(qkv, g, lse, delta, dqkv, n, c, dv,
                                                   split_first, scale);
  return cudaGetLastError();
}

cudaError_t launch_chunked_bf16(const BwdArgs& a, int batch, int num_heads, cudaStream_t stream) {
  constexpr int kDC = kChunkBf16;
  using P = ChunkedBwdTile<kDC>;
  auto dq_kernel = attention_bwd_dq_chunked_wgmma_kernel<kDC>;
  auto dkv_kernel = attention_bwd_dkv_chunked_wgmma_kernel<kDC>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + 63) / 64, chunks = (a.d + kDC - 1) / kDC;
  dq_kernel<<<dim3(tiles * chunks, num_heads, batch), kWgThreads, P::kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(tiles * chunks * 2, num_heads, batch), kWgThreads, P::kSmem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// delta = rowsum(g o) of every (batch element, head, row): a quad of lanes a
// row, each lane the pairs of columns 8 j + 2 (lane % 4) + {0, 1}, then two
// shuffles, the order of the dq kernels above
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                           float* __restrict__ delta, int n, int c, int dv) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, col_lane = 2 * (lane % 4);
  const int row = blockIdx.x * 64 + threadIdx.x / 4;
  float acc = 0.f;
  if (row < n) {
    const bf16* gr = g + (size_t)b * n * c + head * dv + (size_t)row * c;
    const bf16* orow = o + (size_t)b * n * c + head * dv + (size_t)row * c;
    for (int d = col_lane; d < dv; d += 8) {
      const float g1 = d + 1 < dv ? __bfloat162float(gr[d + 1]) : 0.f;
      const float o1 = d + 1 < dv ? __bfloat162float(orow[d + 1]) : 0.f;
      acc = fmaf(__bfloat162float(gr[d]), __bfloat162float(orow[d]), fmaf(g1, o1, acc));
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (lane % 4 == 0 && row < n) delta[((size_t)b * gridDim.y + head) * n + row] = acc;
}

// bf16 at D > 256, N <= 1152: the P-resident route's dq, dk and dv blocks
__global__ void __launch_bounds__(resident::kBlockThreads, 1)
attention_bwd_resident_wgmma_kernel(const __grid_constant__ resident::Args a) {
  resident::run<false>(a);
}

// q, k, v and g as the route's operands, dq, dk and dv at the same offsets of
// dqkv; the delta kernel, then one launch: x = (role * tiles + tile) * split
// + part, roles dq, dk, dv
cudaError_t launch_resident(const BwdArgs& a, int batch, int num_heads, int split,
                            cudaStream_t stream) {
  const long long n = a.n, c = a.c, hd = a.d, c3 = 3 * c;
  // [q(C) | k(C) | v(C)] when split_first, else per head [h0:(q|k|v) | h1:...]
  const long long part = a.split_first ? c : hd, head = a.split_first ? hd : 3 * hd;
  resident::Args r;
  std::memset(static_cast<void*>(&r), 0, sizeof(r));
  for (int i = 0; i < 3; ++i) {
    r.src[i] = {a.qkv + i * part, n * c3, head, c3};
    r.dst[i] = {a.dqkv + i * part, n * c3, head, c3};
  }
  r.src[resident::kG] = {a.g, n * c, hd, c};
  r.lse_in = a.lse;
  r.delta = a.delta;
  r.scale = a.scale;
  r.out_vec2 = hd % 2 == 0;  // dqkv is on 4 bytes; even offsets and strides
  if (!resident::prepare(r, a.n, a.d, num_heads, batch, split, 4, a.vec16 != 0))
    return cudaErrorInvalidValue;
  attention_bwd_delta_kernel<<<dim3((a.n + 63) / 64, num_heads, batch), 256, 0, stream>>>(
      a.g, a.o, a.delta, a.n, a.c, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = resident::smem_bytes(r.tiles, r.slots);
  auto kernel = attention_bwd_resident_wgmma_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(3 * r.tiles * split, num_heads, batch), resident::kBlockThreads, smem, stream>>>(r);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). qkv and dqkv
// are (batch, n, 3c), g and o (batch, n, c), lse the f32 (batch, num_heads,
// n) row log-sum-exp K1 wrote (natural log), delta f32 (batch, num_heads, n)
// scratch; all contiguous on the current device, and for bf16 dqkv on 4
// bytes. A head dim c / num_heads up to 256 runs on the build for the next
// of 32, 64, 128, 192 and 256 up, a larger one on the chunked kernels: route
// 0 the walk, route 1 the P-resident route (bf16, N <= 1152), its columns
// split over `split` blocks a row tile. A route that does not take the call
// is refused. Returns the CUDA error code of the launches (0 on success).
int nd_fused_qkv_attention_bwd_routed(const void* qkv, const void* g, const void* o,
                                      const void* lse, void* dqkv, void* delta, int batch, int n,
                                      int c, int num_heads, int split_first, int dtype,
                                      float scale, int route, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n <= 0 || num_heads <= 0 || c % num_heads != 0 || route < 0 || route > 1 ||
      (route == 1 && (dtype != 1 || c / num_heads <= 256)))
    return (int)cudaErrorInvalidValue;
  const int hd = c / num_heads;
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0) {
    const float* q = static_cast<const float*>(qkv);
    const float* gf = static_cast<const float*>(g);
    const float* of = static_cast<const float*>(o);
    float* d = static_cast<float*>(dqkv);
#define ND_LAUNCH(HC)                                                                        \
  return (int)(hd == HC ? launch_f32<HC, true>(q, gf, of, lse_f, d, delta_f, batch, n, c,     \
                                               num_heads, hd, split_first, scale, s)          \
                        : launch_f32<HC, false>(q, gf, of, lse_f, d, delta_f, batch, n, c,    \
                                                num_heads, hd, split_first, scale, s))
    if (hd <= 32) ND_LAUNCH(32);
    if (hd <= 64) ND_LAUNCH(64);
    if (hd <= 128) ND_LAUNCH(128);
    if (hd <= 192) ND_LAUNCH(192);
    if (hd <= 256) ND_LAUNCH(256);
#undef ND_LAUNCH
    return (int)launch_chunked_f32(q, gf, of, lse_f, d, delta_f, batch, n, c, num_heads, hd,
                                   split_first, scale, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!aligned(dqkv, 4)) return (int)cudaErrorInvalidValue;
  const int vec16 = hd % 8 == 0 && c % 8 == 0 && aligned(qkv, 16) && aligned(g, 16);
  const BwdArgs a = {static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
                     static_cast<const bf16*>(o), lse_f, delta_f, static_cast<bf16*>(dqkv),
                     n, c, split_first, hd, vec16, scale};
  // the build for the smallest head dim that holds hd; at that head dim
  // itself, with aligned rows, its exact instance
  const bool exact = vec16 && aligned(o, 4);
#define ND_LAUNCH(HC)                                                                  \
  return (int)(exact && hd == HC ? launch_bf16<HC, true>(a, batch, num_heads, s)     \
                                 : launch_bf16<HC, false>(a, batch, num_heads, s))
  if (hd <= 32) ND_LAUNCH(32);
  if (hd <= 64) ND_LAUNCH(64);
  if (hd <= 128) ND_LAUNCH(128);
  if (hd <= 192) ND_LAUNCH(192);
  if (hd <= 256) ND_LAUNCH(256);
#undef ND_LAUNCH
  if (route == 1) return (int)launch_resident(a, batch, num_heads, split, s);
  return (int)launch_chunked_bf16(a, batch, num_heads, s);
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
