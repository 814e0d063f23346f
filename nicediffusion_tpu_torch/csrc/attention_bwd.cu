// K2: cotangent of the fused-qkv attention (K1) with respect to qkv.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/attention.py ::
// mha_attention_fused_qkv_bwd (body _fused_bwd_kernel). From the projection
// qkv (B, N, 3C), the output cotangent g (B, N, C) and the forward output o
// (B, N, C) it computes, per batch element and head,
//   p = softmax(q k^T * scale)        recomputed, never stored in device memory
//   delta = rowsum(g * o)             (== rowsum(dp * p), the softmax trick)
//   dv = p^T g;  dp = g v^T;  ds = p * (dp - delta) * scale
//   dq = ds k;   dk = ds^T q
// and writes dq, dk and dv at the channel offsets of q, k and v in a
// (B, N, 3C) tensor, in either qkv layout. The residuals are qkv and o, as
// in the JAX package's custom VJP: K1 hands over no log-sum-exp, the first
// kernel here makes it (one more q k^T pass) and keeps K1 as it is.
//
// Design. The TPU kernel ran one program per batch element, unrolled the
// heads, kept whole (N, hc) dk and dv sums in VMEM across a sequential loop
// of query tiles and took the softmax over the whole key row at once. On
// Hopper blocks run in no order and a block has 227 KB of shared memory, so
// the work is cut twice, with no atomics (the result is the same from run
// to run):
//   * dq kernel, one block per (query tile, head, batch element): holds
//     its q and g tiles, walks the 64-key tiles once for the row max and sum
//     (online, as K1), takes delta from g and o, then walks them again,
//     recomputes p from the log-sum-exp and accumulates dq in registers. It
//     leaves the log-sum-exp and delta of its rows in two small f32 (B, H, N)
//     scratch tensors.
//   * dk/dv kernel, one block per (key tile, head, batch element): holds
//     its k and v tiles, walks the 64-query tiles, recomputes p and ds from
//     the scratch rows and accumulates dk and dv in registers.
// Tiling, in-kernel offsets and the one-word bank padding are K1's. At head
// dims 192 and 256 four 64-row f32 tiles of HC + 1 words do not fit a
// block's 232,448 B (the dk/dv kernel needs 232,960 B at 192, the dq kernel
// 280,576 B at 256), so there the tile a block owns has 32 rows (BM query
// rows in the dq kernel, BN keys in the dk/dv kernel) while the tiles it walks
// keep 64: 206,080 and 216,320 B at 256. A thread then owns 2 rows of its
// accumulators, 2 x HC/16 registers of each at most 32, as many as at head
// dim 128 with 4 rows, and twice as many blocks fill the card at the short
// N these head dims come with. Head dims 32, 64 and 128 keep 64-row tiles.
// The ragged N edge is masked in the kernels: keys past N get p = 0, rows past
// N load as zero and are never stored, and every element of the output
// belonging to a row below N is written by exactly one thread.
// Rounding follows the TPU kernel: p is rounded to the input type before
// p^T g, and ds (made from the rounded p) before ds k and ds^T q; all sums
// are f32 FMA, so f32 inputs never see TF32.
//
// What bounds it. Operations: eight 64 x 64 x hc tile products per
// (query tile, key tile) pair (three in the first kernel's second pass, one
// in its first, four in the second kernel) against five in the formulas,
// all on the CUDA cores with two shared-memory loads per four FMAs, as K1.
// The tensor cores (mma/wgmma for the bf16 path) and handing the
// log-sum-exp over from K1 are later work.

#include "attention_common.cuh"

namespace {

using namespace nd;

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
template <typename T, int HC, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int row0, int n, int tid) {
  for (int i = tid; i < ROWS * HC; i += kThreads) {
    const int r = i / HC, d = i % HC, row = row0 + r;
    dst[r * (HC + 1) + d] = row < n ? to_f32(src[(size_t)row * row_stride + d]) : 0.f;
  }
}

template <typename T, int HC, int BM>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                        const T* __restrict__ o, T* __restrict__ dqkv,
                        float* __restrict__ lse, float* __restrict__ delta, int n, int c,
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
  const T* base = qkv + (size_t)b * n * c3;
  const T* gbase = g + (size_t)b * n * c + head * HC;
  const T* obase = o + (size_t)b * n * c + head * HC;

  load_tile<T, HC, BM>(qs, base + off.q, c3, q0, n, tid);
  load_tile<T, HC, BM>(gs, gbase, c, q0, n, tid);

  // pass 1: running row max and sum over the keys
  float m[TR], l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks
    load_tile<T, HC>(ks, base + off.k, c3, k0, n, tid);
    __syncthreads();
    float s[TR][kTC];
    tile_dot_nt<HC, TR>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        s[i][j] = (k0 + tx + 16 * j < n) ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTC; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
  }

  // log-sum-exp and delta = rowsum(g * o) of this thread's rows
  float row_lse[TR], row_delta[TR];
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i, row = q0 + r;
    row_lse[i] = m[i] + logf(l[i]);
    float acc = 0.f;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < kOC; ++j) {
        const int d = tx + 16 * j;
        acc = fmaf(gs[r * kS + d], to_f32(obase[(size_t)row * c + d]), acc);
      }
    }
    row_delta[i] = row_sum16(acc);
    if (tx == 0 && row < n) {
      lse[stat_base + row] = row_lse[i];
      delta[stat_base + row] = row_delta[i];
    }
  }

  // pass 2: recompute p, form ds, accumulate dq = ds k
  float dq[TR][kOC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    load_tile<T, HC>(ks, base + off.k, c3, k0, n, tid);
    load_tile<T, HC>(vs, base + off.v, c3, k0, n, tid);
    __syncthreads();
    float s[TR][kTC], dp[TR][kTC];
    tile_dot_nt<HC, TR>(qs, ks, ty, tx, s);
    tile_dot_nt<HC, TR>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const bool valid = k0 + tx + 16 * j < n;
        const float p = valid ? round_to<T>(expf(s[i][j] * scale - row_lse[i])) : 0.f;
        dss[(ty * TR + i) * kPStride + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
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
    T* dst = dqkv + ((size_t)b * n + row) * c3 + off.q;
#pragma unroll
    for (int j = 0; j < kOC; ++j) dst[tx + 16 * j] = from_f32<T>(dq[i][j]);
  }
}

template <typename T, int HC, int BN>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dqkv, int n, int c, int split_first, float scale) {
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
  const T* base = qkv + (size_t)b * n * c3;
  const T* gbase = g + (size_t)b * n * c + head * HC;
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;

  load_tile<T, HC, BN>(ks, base + off.k, c3, k0, n, tid);
  load_tile<T, HC, BN>(vs, base + off.v, c3, k0, n, tid);

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
    load_tile<T, HC>(qs, base + off.q, c3, q0, n, tid);
    load_tile<T, HC>(gs, gbase, c, q0, n, tid);
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
        const float p = valid ? round_to<T>(expf(s[i][j] * scale - lse_s[r])) : 0.f;
        ps[r * PS + col] = p;
        dss[r * PS + col] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
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
    T* dst = dqkv + ((size_t)b * n + key) * c3;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      dst[off.k + tx + 16 * j] = from_f32<T>(dk[i][j]);
      dst[off.v + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int HC>
cudaError_t launch(const void* qkv, const void* g, const void* o, void* dqkv, float* lse,
                   float* delta, int batch, int n, int c, int num_heads, int split_first,
                   float scale, cudaStream_t stream) {
  constexpr int kOwn = own_rows<HC>();  // BM of the dq kernel, BN of the dk/dv kernel
  auto dq_kernel = attention_bwd_dq_kernel<T, HC, kOwn>;
  auto dkv_kernel = attention_bwd_dkv_kernel<T, HC, kOwn>;
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
  dq_kernel<<<grid, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<const T*>(o),
      static_cast<T*>(dqkv), lse, delta, n, c, split_first, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dqkv), n, c, split_first, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* qkv, const void* g, const void* o, void* dqkv,
                              float* lse, float* delta, int batch, int n, int c,
                              int num_heads, int split_first, float scale,
                              cudaStream_t stream) {
#define ND_LAUNCH(HC)                                                                   \
  return launch<T, HC>(qkv, g, o, dqkv, lse, delta, batch, n, c, num_heads, split_first, \
                       scale, stream)
  switch (c / num_heads) {
    case 32: ND_LAUNCH(32);
    case 64: ND_LAUNCH(64);
    case 128: ND_LAUNCH(128);
    case 192: ND_LAUNCH(192);
    case 256: ND_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef ND_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv and dqkv are (batch, n, 3c), g and o
// (batch, n, c), lse and delta f32 (batch, num_heads, n) scratch; all
// contiguous on the current device. Returns the CUDA error code of the
// launches (0 on success).
int nd_fused_qkv_attention_bwd(const void* qkv, const void* g, const void* o, void* dqkv,
                               void* lse, void* delta, int batch, int n, int c,
                               int num_heads, int split_first, int dtype, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_heads <= 0 || c % num_heads != 0) return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(qkv, g, o, dqkv, lse_f, delta_f, batch, n, c,
                                         num_heads, split_first, scale, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(qkv, g, o, dqkv, lse_f, delta_f, batch, n,
                                                 c, num_heads, split_first, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
