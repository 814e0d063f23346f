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
//   * dq kernel, one block per (64-query tile, head, batch element): holds
//     its q and g tiles, walks the 64-key tiles once for the row max and sum
//     (online, as K1), takes delta from g and o, then walks them again,
//     recomputes p from the log-sum-exp and accumulates dq in registers. It
//     leaves the log-sum-exp and delta of its rows in two small f32 (B, H, N)
//     scratch tensors.
//   * dk/dv kernel, one block per (64-key tile, head, batch element): holds
//     its k and v tiles, walks the 64-query tiles, recomputes p and ds from
//     the scratch rows and accumulates dk and dv in registers.
// Tiling, in-kernel offsets and the one-word bank padding are K1's. The
// ragged N edge is masked in the kernels: keys past N get p = 0, rows past
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

template <int HC>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBM * (HC + 1) + kBM * kPStride);
}

template <int HC>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBM * (HC + 1) + 2 * kBM * kPStride + 2 * kBM);
}

// rows [row0, row0 + 64) of one head's hc channels -> a shared tile of row
// stride HC + 1, zero past row n
template <typename T, int HC>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int row0, int n, int tid) {
  for (int i = tid; i < kBM * HC; i += kThreads) {
    const int r = i / HC, d = i % HC, row = row0 + r;
    dst[r * (HC + 1) + d] = row < n ? to_f32(src[(size_t)row * row_stride + d]) : 0.f;
  }
}

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                        const T* __restrict__ o, T* __restrict__ dqkv,
                        float* __restrict__ lse, float* __restrict__ delta, int n, int c,
                        int split_first, float scale) {
  constexpr int kS = HC + 1;
  constexpr int kOC = HC / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // kBM x kS
  float* gs = qs + kBM * kS;    // kBM x kS
  float* ks = gs + kBM * kS;    // kBN x kS
  float* vs = ks + kBN * kS;    // kBN x kS
  float* dss = vs + kBN * kS;   // kBM x kPStride

  const int q0 = blockIdx.x * kBM;
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

  load_tile<T, HC>(qs, base + off.q, c3, q0, n, tid);
  load_tile<T, HC>(gs, gbase, c, q0, n, tid);

  // pass 1: running row max and sum over the keys
  float m[kTR], l[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks
    load_tile<T, HC>(ks, base + off.k, c3, k0, n, tid);
    __syncthreads();
    float s[kTR][kTC];
    tile_dot_nt<HC>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
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
  float row_lse[kTR], row_delta[kTR];
  const size_t stat_base = ((size_t)b * gridDim.y + head) * n;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = ty * kTR + i, row = q0 + r;
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
  float dq[kTR][kOC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    load_tile<T, HC>(ks, base + off.k, c3, k0, n, tid);
    load_tile<T, HC>(vs, base + off.v, c3, k0, n, tid);
    __syncthreads();
    float s[kTR][kTC], dp[kTR][kTC];
    tile_dot_nt<HC>(qs, ks, ty, tx, s);
    tile_dot_nt<HC>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const bool valid = k0 + tx + 16 * j < n;
        const float p = valid ? round_to<T>(expf(s[i][j] * scale - row_lse[i])) : 0.f;
        dss[(ty * kTR + i) * kPStride + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBN; ++k) {
      float dv_[kTR], kv[kOC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) dv_[i] = dss[(ty * kTR + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOC; ++j) kv[j] = ks[k * kS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) dq[i][j] = fmaf(dv_[i], kv[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = q0 + ty * kTR + i;
    if (row >= n) continue;
    T* dst = dqkv + ((size_t)b * n + row) * c3 + off.q;
#pragma unroll
    for (int j = 0; j < kOC; ++j) dst[tx + 16 * j] = from_f32<T>(dq[i][j]);
  }
}

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dqkv, int n, int c, int split_first, float scale) {
  constexpr int kS = HC + 1;
  constexpr int kOC = HC / 16;  // dk and dv columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                    // kBN x kS
  float* vs = ks + kBN * kS;           // kBN x kS
  float* qs = vs + kBN * kS;           // kBM x kS
  float* gs = qs + kBM * kS;           // kBM x kS
  float* ps = gs + kBM * kS;           // kBM x kPStride
  float* dss = ps + kBM * kPStride;    // kBM x kPStride
  float* lse_s = dss + kBM * kPStride; // kBM
  float* delta_s = lse_s + kBM;        // kBM

  const int k0 = blockIdx.x * kBN;
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

  load_tile<T, HC>(ks, base + off.k, c3, k0, n, tid);
  load_tile<T, HC>(vs, base + off.v, c3, k0, n, tid);

  // this thread's keys are ty * kTR + i, its channels tx + 16 * j
  float dk[kTR][kOC], dv[kTR][kOC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
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
    float s[kTR][kTC], dp[kTR][kTC];
    tile_dot_nt<HC>(qs, ks, ty, tx, s);
    tile_dot_nt<HC>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty * kTR + i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int col = tx + 16 * j;
        const bool valid = (q0 + r < n) && (k0 + col < n);
        const float p = valid ? round_to<T>(expf(s[i][j] * scale - lse_s[r])) : 0.f;
        ps[r * kPStride + col] = p;
        dss[r * kPStride + col] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

    // dv += p^T g and dk += ds^T q over the tile's query rows
#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      float pk[kTR], dsk[kTR], gv[kOC], qv[kOC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        pk[i] = ps[r * kPStride + ty * kTR + i];
        dsk[i] = dss[r * kPStride + ty * kTR + i];
      }
#pragma unroll
      for (int j = 0; j < kOC; ++j) {
        gv[j] = gs[r * kS + tx + 16 * j];
        qv[j] = qs[r * kS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) {
          dv[i][j] = fmaf(pk[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(dsk[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int key = k0 + ty * kTR + i;
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
  auto dq_kernel = attention_bwd_dq_kernel<T, HC>;
  auto dkv_kernel = attention_bwd_dkv_kernel<T, HC>;
  constexpr size_t dq_smem = dq_smem_bytes<HC>();
  constexpr size_t dkv_smem = dkv_smem_bytes<HC>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBM - 1) / kBM, num_heads, batch);
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
