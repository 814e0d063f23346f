// K1: multi-head self-attention read straight from the fused qkv projection.
//
// Replaces the TPU kernel nicediffusion_tpu/ops/pallas/attention.py ::
// mha_attention_fused_qkv (body _fused_kernel). For every batch element and
// head it computes softmax(q k^T * hc^-0.5) v, reading q, k and v at their
// channel offsets inside the (B, N, 3C) projection, in either checkpoint
// layout ([q|k|v], or per-head interleaved [h0:(q|k|v) | h1:...]), and
// writes (B, N, C) with the heads contiguous. Nothing is transposed or
// padded in device memory.
//
// Design. The TPU kernel kept a whole (N, N) f32 logits tile in VMEM. On
// Hopper a block has at most 227 KB of shared memory, and at N = 1024 the
// logits of 64 query rows alone are 256 KB, so this kernel is flash-style:
//   * one block per (64-query tile, head, batch element), 256 threads;
//   * a loop over 64-key tiles with an online softmax (running row max and
//     row sum in registers, the output accumulator rescaled per tile);
//   * q, k and v tiles staged in shared memory as f32 (k rows padded by one
//     word so the 16 lanes that read 16 different keys hit 16 banks);
//   * each thread owns a 4x4 block of the 64x64 score tile and a 4 x hc/16
//     block of the output, reductions over a row are 16-lane shuffles;
//   * the ragged N edge is masked in the kernel: keys past N score -1e30
//     (finite, as in the TPU kernel), query rows past N are not stored.
// Logits, softmax and accumulation are f32 for both input types. For bf16
// inputs p is rounded to bf16 before the product with v, as the JAX kernel
// casts p to v's dtype.
//
// What bounds it. The products run on the CUDA cores in f32 FMA, with two
// shared-memory loads per four FMAs, so the kernel is bound by shared-memory
// bandwidth and FMA issue, far below the tensor cores' rate. The f32 path
// must hold 2e-5 against an f32 reference, which TF32 tensor cores cannot;
// moving the bf16 path onto mma/wgmma is later work (ROADMAP queue B).

#include "attention_common.cuh"

namespace {

using namespace nd;

template <int HC>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBM * (HC + 1) + kBN * (HC + 1) + kBN * HC + kBM * kPStride);
}

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
fused_qkv_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n,
                           int c, int split_first, float scale) {
  constexpr int kQK = HC + 1;     // padded row stride of the q and k tiles
  constexpr int kOC = HC / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // kBM x kQK
  float* ks = qs + kBM * kQK;     // kBN x kQK
  float* vs = ks + kBN * kQK;     // kBN x HC
  float* ps = vs + kBN * HC;      // kBM x kPStride

  const int q0 = blockIdx.x * kBM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int c3 = 3 * c;

  const QkvOffsets off = qkv_offsets(head, HC, c, split_first);
  const int qo = off.q, ko = off.k, vo = off.v;
  const T* base = qkv + (size_t)b * n * c3;

  for (int i = tid; i < kBM * HC; i += kThreads) {
    const int r = i / HC, d = i % HC, row = q0 + r;
    qs[r * kQK + d] = row < n ? to_f32(base[(size_t)row * c3 + qo + d]) : 0.f;
  }

  float o[kTR][kOC];
  float m[kTR], l[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOC; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int i = tid; i < kBN * HC; i += kThreads) {
      const int r = i / HC, d = i % HC, row = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < n) {
        const T* p = base + (size_t)row * c3;
        kv = to_f32(p[ko + d]);
        vv = to_f32(p[vo + d]);
      }
      ks[r * kQK + d] = kv;
      vs[r * HC + d] = vv;
    }
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
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * kTR + i) * kPStride + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOC; ++j) o[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kBN; ++k) {
      float pv[kTR], vv[kOC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) pv[i] = ps[(ty * kTR + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOC; ++j) vv[j] = vs[k * HC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kOC; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = q0 + ty * kTR + i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    T* dst = out + ((size_t)b * n + row) * c + head * HC;
#pragma unroll
    for (int j = 0; j < kOC; ++j) dst[tx + 16 * j] = from_f32<T>(o[i][j] * inv);
  }
}

template <typename T, int HC>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int c, int num_heads,
                   int split_first, float scale, cudaStream_t stream) {
  auto kernel = fused_qkv_attention_kernel<T, HC>;
  constexpr size_t smem = smem_bytes<HC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBM - 1) / kBM, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                           n, c, split_first, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* qkv, void* out, int batch, int n, int c,
                              int num_heads, int split_first, float scale,
                              cudaStream_t stream) {
  switch (c / num_heads) {
    case 32: return launch<T, 32>(qkv, out, batch, n, c, num_heads, split_first, scale, stream);
    case 64: return launch<T, 64>(qkv, out, batch, n, c, num_heads, split_first, scale, stream);
    case 128: return launch<T, 128>(qkv, out, batch, n, c, num_heads, split_first, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv is (batch, n, 3c) and out is
// (batch, n, c), both contiguous on the current device. Returns the CUDA
// error code of the launch (0 on success).
int nd_fused_qkv_attention(const void* qkv, void* out, int batch, int n, int c,
                           int num_heads, int split_first, int dtype, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_heads <= 0 || c % num_heads != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(qkv, out, batch, n, c, num_heads, split_first,
                                         scale, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(qkv, out, batch, n, c, num_heads,
                                                 split_first, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
