// K1 and K5: multi-head self-attention, softmax(q k^T * scale) v, one kernel
// behind two entry points.
//
// K1 replaces the TPU kernel nicediffusion_tpu/ops/pallas/attention.py ::
// mha_attention_fused_qkv (body _fused_kernel): q, k and v are read at their
// channel offsets inside the fused (B, N, 3C) projection, in either
// checkpoint layout ([q|k|v], or per-head interleaved [h0:(q|k|v) | h1:...]),
// and the result is written as (B, N, C) with the heads contiguous.
// K5 replaces mha_attention in the same file (body _attn_kernel): q, k and v
// are separate (B, H, N, D) tensors of any batch, head and row strides, and
// the result is a contiguous (B, H, N, D).
//
// Both are the same function of three strided views, so the kernel takes
// three base pointers with their batch, head and row strides (in elements;
// the last axis is contiguous) and K1 is the case where the three pointers
// are offsets into one projection. Nothing is transposed or padded in
// device memory. The kernel is built for head dims 32, 64, 128, 192 and
// 256; a head dim D between two of them (K5 only) runs the next one up with
// the columns past D zero-filled in shared memory and never stored, which is
// the TPU kernel's zero-padding to 128 lanes without the device-memory copy.
// The scale is the caller's, from the true D.
//
// Design. The TPU kernels kept a whole (N, N) f32 logits tile in VMEM. On
// Hopper a block has at most 227 KB of shared memory, and at N = 1024 the
// logits of 64 query rows alone are 256 KB, so this kernel is flash-style:
//   * one block per (64-query tile, head, batch element), 256 threads;
//   * a loop over 64-key tiles with an online softmax (running row max and
//     row sum in registers, the output accumulator rescaled per tile);
//   * q, k and v tiles staged in shared memory as f32 (k rows padded by one
//     word so the 16 lanes that read 16 different keys hit 16 banks), a warp
//     a row with its lanes along the head dim, so a row's 64-bit offset is
//     taken once and the reads coalesce;
//   * each thread owns a 4x4 block of the 64x64 score tile and a 4 x HC/16
//     block of the output, reductions over a row are 16-lane shuffles;
//   * the ragged N edge is masked in the kernel: keys past N score -1e30
//     (finite, as in the TPU kernels), query rows past N are not stored.
// Logits, softmax and accumulation are f32 for both input types. For bf16
// inputs p is rounded to bf16 before the product with v, as the JAX kernels
// cast p to v's dtype.
//
// Shared memory is 4 * (2 * 64 * (HC + 1) + 64 * HC + 64 * 68) bytes:
// 165,376 at HC = 192 and 214,528 at HC = 256, under a block's 232,448, one
// block a multiprocessor. A thread's accumulator is 4 x HC/16 registers, 64
// at HC = 256.
//
// What bounds it. The products run on the CUDA cores in f32 FMA, with two
// shared-memory loads per four FMAs, so the kernel is bound by shared-memory
// bandwidth and FMA issue, far below the tensor cores' rate. The f32 path
// must hold 2e-5 against an f32 reference, which TF32 tensor cores cannot;
// moving the bf16 path onto mma/wgmma is later work (ROADMAP queue B).

#include "attention_common.cuh"

namespace {

using namespace nd;

// one of q, k, v or the output: element strides of the batch, head and row
// axes; the last axis has stride 1
struct View {
  long long b, h, n;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  View qs, ks, vs, os;
  int n;        // tokens
  int d;        // head dim in device memory, <= HC
  float scale;  // d^-0.5
};

template <int HC>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBM * (HC + 1) + kBN * (HC + 1) + kBN * HC + kBM * kPStride);
}

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const AttnArgs a) {
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
  const int n = a.n, dv = a.d;
  const float scale = a.scale;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + head * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + head * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + head * a.vs.h;
  T* ob = static_cast<T*>(a.o) + b * a.os.b + head * a.os.h;
  const long long q_n = a.qs.n, k_n = a.ks.n, v_n = a.vs.n, o_n = a.os.n;

  // a warp stages a row at a time, its lanes along the head dim: one 64-bit
  // row offset a row, coalesced reads, conflict-free shared-memory writes
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = q0 + r;
    const T* src = qb + row * q_n;
#pragma unroll
    for (int d = lane; d < HC; d += 32)
      qs[r * kQK + d] = (row < n && d < dv) ? to_f32(src[d]) : 0.f;
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
    for (int r = warp; r < kBN; r += kThreads / 32) {
      const int row = k0 + r;
      const T* ksrc = kb + row * k_n;
      const T* vsrc = vb + row * v_n;
#pragma unroll
      for (int d = lane; d < HC; d += 32) {
        const bool valid = row < n && d < dv;
        ks[r * kQK + d] = valid ? to_f32(ksrc[d]) : 0.f;
        vs[r * HC + d] = valid ? to_f32(vsrc[d]) : 0.f;
      }
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
    T* dst = ob + row * o_n;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      const int d = tx + 16 * j;
      if (d < dv) dst[d] = from_f32<T>(o[i][j] * inv);
    }
  }
}

template <typename T, int HC>
cudaError_t launch(const AttnArgs& a, int batch, int heads, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, HC>;
  constexpr size_t smem = smem_bytes<HC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the kernel built for the smallest head dim that holds a.d
template <typename T>
cudaError_t dispatch_head_dim(const AttnArgs& a, int batch, int heads, cudaStream_t stream) {
  if (a.d <= 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return launch<T, 32>(a, batch, heads, stream);
  if (a.d <= 64) return launch<T, 64>(a, batch, heads, stream);
  if (a.d <= 128) return launch<T, 128>(a, batch, heads, stream);
  if (a.d <= 192) return launch<T, 192>(a, batch, heads, stream);
  if (a.d <= 256) return launch<T, 256>(a, batch, heads, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16
int dispatch(const AttnArgs& a, int batch, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || heads <= 0 || a.n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_head_dim<float>(a, batch, heads, s);
  if (dtype == 1) return (int)dispatch_head_dim<__nv_bfloat16>(a, batch, heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1. qkv is (batch, n, 3c) and out is (batch, n, c), both contiguous on the
// current device. Returns the CUDA error code of the launch (0 on success).
int nd_fused_qkv_attention(const void* qkv, void* out, int batch, int n, int c,
                           int num_heads, int split_first, int dtype, float scale,
                           void* stream) {
  if (num_heads <= 0 || c % num_heads != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long hc = c / num_heads, c3 = 3LL * c;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  // [q(C) | k(C) | v(C)] when split_first, else per head [h0:(q|k|v) | h1:...]
  const long long part = split_first ? c : hc;        // from q to k, from k to v
  const View in = {(long long)n * c3, split_first ? hc : 3 * hc, c3};
  const char* base = static_cast<const char*>(qkv);
  AttnArgs a;
  a.q = base;
  a.k = base + part * elem;
  a.v = base + 2 * part * elem;
  a.o = out;
  a.qs = a.ks = a.vs = in;
  a.os = {(long long)n * c, hc, c};
  a.n = n;
  a.d = (int)hc;
  a.scale = scale;
  return dispatch(a, batch, num_heads, dtype, stream);
}

// K5. q, k and v are (batch, heads, n, d) views with the given element
// strides of their batch, head and row axes (the last axis contiguous); out
// is a contiguous (batch, heads, n, d). Returns the CUDA error code.
int nd_mha_attention(const void* q, const void* k, const void* v, void* out, int batch,
                     int heads, int n, int d, const long long* q_strides,
                     const long long* k_strides, const long long* v_strides, int dtype,
                     float scale, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.qs = {q_strides[0], q_strides[1], q_strides[2]};
  a.ks = {k_strides[0], k_strides[1], k_strides[2]};
  a.vs = {v_strides[0], v_strides[1], v_strides[2]};
  a.os = {(long long)heads * n * d, (long long)n * d, d};
  a.n = n;
  a.d = d;
  a.scale = scale;
  return dispatch(a, batch, heads, dtype, stream);
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
