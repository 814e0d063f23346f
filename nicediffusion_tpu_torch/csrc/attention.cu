// K1 and K5: multi-head self-attention, softmax(q k^T * scale) v, one
// kernel for each input type behind two entry points.
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
// Both are the same function of three strided views, so the kernels take
// three base pointers with their batch, head and row strides (in elements;
// the last axis is contiguous) and K1 is the case where the three pointers
// are offsets into one projection. Nothing is transposed or padded in
// device memory. The kernels are built for head dims 32, 64, 128, 192 and
// 256; a head dim D between two of them runs the next one up with the
// columns past D zero-filled in shared memory and never stored, which is the
// TPU kernel's zero-padding to 128 lanes without the device-memory copy. A
// head dim above 256 runs the chunked kernels (below). The scale is the
// caller's, from the true D.
//
// The TPU kernels kept a whole (N, N) f32 logits tile in VMEM. On Hopper a
// block has at most 227 KB of shared memory, and at N = 1024 the logits of
// 64 query rows alone are 256 KB, so both kernels are flash-style: a block
// per (64-query tile, head, batch element), a loop over key tiles with an
// online softmax (running row max and row sum in registers, the output
// accumulator rescaled per tile), keys past N scored -1e30 (finite, as in
// the TPU kernels), query rows past N not stored. Logits, softmax and
// accumulation are f32 for both input types.
//
// bf16: the tensor cores (attention_fwd_wgmma_kernel). One warpgroup (128
// threads) owns one 64-query tile; a block holds two of them (128 query
// rows, 256 threads), which share the K/V ring.
//   * S = Q K^T is a wgmma m64n64k16 (bf16 in, f32 out) with Q and K both
//     read from shared memory through matrix descriptors; K is the B operand
//     as it lies (K-major), nothing is transposed.
//   * O += P V is a second wgmma with P as the A operand from registers: the
//     f32 accumulator layout of S is the A-fragment layout once packed to
//     bf16 pairs, so P never goes through shared memory. V is the B operand
//     in MN-major form, as it lies; one m64n64k16 per 64 columns of D.
//   * O (64 x D f32 a warpgroup) stays in registers. A thread owns two rows
//     of S and O; a row lies in the 4 lanes of a quad, so its max and sum
//     are two __shfl_xor_sync steps, and the rescale of O and the key mask
//     work in the accumulator layout.
//   * Q is staged once, K and V through a two-stage ring with 16-byte
//     cp.async (zero fill for rows past N and columns past D), in the
//     128-byte-swizzled layout the descriptors name (sm90.cuh): tile t + 1
//     loads while tile t multiplies. A view whose base or strides are not
//     multiples of 16 bytes is staged with 2-byte loads instead.
// Rounding points: q k^T summed in f32 (JAX's preferred_element_type=f32);
// p rounded to bf16 before the product with v. That p is unnormalised (at
// most 1), and the row sum (of the unrounded p) divides at the end; the JAX
// kernel normalises first and then casts (attention.py:134-141). The two
// differ by about one bf16 ulp of p, inside the bf16 gate of 3e-2. The
// exponentials are ex2.approx (relative error about 2^-22) on scores
// scaled by scale * log2(e) in one FMA.
// K5 on views of a projection is bit-equal to K1 on it: one kernel, one
// tile order, one shared-memory image whichever loader staged it.
//
// The row log-sum-exp. K1 called for a gradient (the autograd Function)
// also writes, for each query row, lse = ln sum_j exp(scale q k_j) (natural
// log, of the scaled logits) as an f32 (B, H, N) tensor, from the running
// max and sum it already holds: K2 then recomputes p = exp(scale q k - lse)
// without a pass of its own over the keys. Both kernels write it; inference
// calls and K5 pass a null pointer and write none.
//
// Budget per head dim D (bf16). D = 32 is staged 64 columns wide (zeros past
// 32). Shared memory: Q (128 rows) + 2 stages of K and V (64 rows each) =
// 6 x 64 x max(D, 64) x 2 bytes + 1 KB of alignment: 50,176 bytes at
// D <= 64, 99,328 at 128, 148,480 at 192, 197,632 at 256. Registers a
// thread: O is D / 2, S 32, P 16. ptxas (-Xptxas -v, CUDA 12.8): 119, 118,
// 134, 170 and 215 registers at D = 32, 64, 128, 192, 256, no spill, so two
// blocks (four warpgroups) a multiprocessor at D <= 64 and one above.
//
// What bounds it: at N = 1024 the work is 2 N^2 D flops a head against 4 N D
// bytes, so the bound is the tensor cores' rate (989 TFLOP/s), not device
// memory. The kernel reaches about a quarter of it (PERF.md): within a
// warpgroup the two products and the softmax run in turn, and per 64 x 64
// tile the exponentials (4,096 on the multifunction unit, 16 a clock per
// multiprocessor) and the shared-memory reads of S's two operands (128
// bytes a clock at the tensor rate, the whole shared-memory bandwidth) each
// take as long as the products. Warpgroups of other tiles fill the gaps.
// TMA, a producer warp and ping-pong scheduling of two consumer warpgroups
// are later work (ROADMAP queue B).
//
// f32: the CUDA cores (attention_fwd_kernel), unchanged. The f32 path must
// hold 2e-5 against an f32 reference, which TF32 tensor cores cannot.
//   * 256 threads a block, a loop over 64-key tiles;
//   * q, k and v tiles staged in shared memory as f32 (k rows padded by one
//     word so the 16 lanes that read 16 different keys hit 16 banks), a warp
//     a row with its lanes along the head dim;
//   * each thread owns a 4x4 block of the 64x64 score tile and a 4 x HC/16
//     block of the output, reductions over a row are 16-lane shuffles.
// Shared memory is 4 * (2 * 64 * (HC + 1) + 64 * HC + 64 * 68) bytes:
// 165,376 at HC = 192 and 214,528 at HC = 256, one block a multiprocessor.
// It is bound by shared-memory bandwidth and FMA issue (two shared loads
// per four FMAs).
//
// Head dims above 256: two routes (attention_chunked.cuh), chosen by the
// host's plan (ops/kernels/attention.py :: chunked_attention_plan) from N and
// D; only its split of a tile's columns over blocks reads the number of
// (batch, head) pairs, and no split changes a bit.
//   * The P-resident route (bf16, N <= 1152: attention_fwd_resident_wgmma_
//     kernel). A block owns a 64-query tile of one head: pass 1 makes S_t
//     once for every key tile t (summed over 64-column chunks of D in chunk
//     order), runs the online softmax (the running row max handed from one
//     consumer warpgroup to the other, which take alternate key tiles) and
//     keeps the bf16 p_t (8 KB a tile, 128 KB at N = 1024) and the
//     correction and row sum of each row in shared memory; pass 2 walks the
//     output's 64-column blocks, up to four a warpgroup at once: O *= corr_t,
//     O += p_t V_t with p_t as wgmma's A by descriptor. S is made once a
//     (query tile, key tile) pair: the products the function needs, no more
//     (a split over s blocks repeats pass 1: (s + 1) / 2). A producer
//     warpgroup feeds a ring of 16 KB stages by TMA (a 4-D map over each of
//     q, k and v) under mbarriers. Shared memory 1,680 bytes + 16 KB a stage
//     (4 to 8) + 8,704 a key tile: 222,864 bytes at N = 1024 (5 stages).
//     ptxas (CUDA 12.8): 168 registers (the cap of 384 threads; setmaxnreg
//     gives the consumers 224 and the producer 56), no spill, no stack.
//   * The walk (bf16 above N = 1152, f32 always; the kernels below): a
//     grid axis over 256-column chunks of the output, the block of (query
//     tile, chunk) summing S over the 64-column chunks of D, streamed through
//     a two-stage cp.async ring, and accumulating only its chunk; every block
//     of a query tile runs the same sums in the same order, so their p, row
//     max and row sum agree bit for bit; chunk 0 alone writes the lse. Its
//     price is S made once per output chunk: (ceil(D / 256) + 1) / 2 of the
//     products, 1.5x at D = 512. bf16 (attention_fwd_chunked_wgmma_kernel):
//     two warpgroups, 128 query rows, 82,944 bytes, 216 registers; f32
//     (attention_fwd_chunked_kernel): 116,224 bytes, 128 registers.
// Both routes give the same bits (the same sums in the same order, the same
// roundings). Columns past D land as zeros and are not stored; views that
// allow no 16-byte copy are staged with 2-byte loads. What bounds them on
// this card: at N = 1024, D = 512 the two products are 2 N^2 D flops a head
// against 4 N D bytes: the tensor cores (989 TFLOP/s); a block streams K and
// V from L2 once and Q once a key tile.

#include "attention_chunked.cuh"
#include "attention_common.cuh"
#include "sm90.cuh"

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
  float* lse;    // K1 only, may be null: the row log-sum-exp, f32 (batch, heads, n)
  View qs, ks, vs, os;
  int n;         // tokens
  int d;         // head dim in device memory: <= HC, or any above 256 (chunked)
  float scale;   // d^-0.5
  int vec16;     // bf16: q, k, v bases and strides are multiples of 16 bytes
  int out_vec2;  // bf16: the output's base and strides allow 4-byte stores
};

// ---------------------------------------------------------------- f32, FMA

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
    // m is the row max of the scaled logits: lse = m + ln(l)
    if (a.lse != nullptr && tx == 0)
      a.lse[((size_t)b * gridDim.y + head) * n + row] = m[i] + logf(l[i]);
    const float inv = 1.f / l[i];
    T* dst = ob + row * o_n;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      const int d = tx + 16 * j;
      if (d < dv) dst[d] = from_f32<T>(o[i][j] * inv);
    }
  }
}

template <int HC>
cudaError_t launch_f32(const AttnArgs& a, int batch, int heads, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<float, HC>;
  constexpr size_t smem = smem_bytes<HC>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16, tensor cores

constexpr int kWgThreads = 128;               // one warpgroup: one 64-query tile
constexpr int kWgs = 2;                       // warpgroups a block, sharing the K/V ring
constexpr int kBlockThreads = kWgs * kWgThreads;
constexpr int kBlockRows = kWgs * kBM;        // query rows a block
constexpr int kWgBN = 64;                     // keys per tile

template <int HC>
struct WgmmaTile {
  static constexpr int kDP = HC < 64 ? 64 : HC;  // staged width: whole 128-byte rows
  static constexpr int kCB = kDP / 64;           // 64-column blocks
  static constexpr int kQBytes = kBlockRows * kDP * 2;
  static constexpr int kKVBytes = kWgBN * kDP * 2;  // one K or V tile
  // Q, two stages of K and V, and room to put Q on a 1024-byte boundary
  static constexpr size_t kSmem = kQBytes + 4 * kKVBytes + 1024;
};

template <int HC>
__global__ void __launch_bounds__(kBlockThreads)
attention_fwd_wgmma_kernel(const AttnArgs a) {
  using Tile = WgmmaTile<HC>;
  constexpr int kDP = Tile::kDP, kCB = Tile::kCB;
  constexpr int kKV = Tile::kKVBytes;
  constexpr uint32_t kSbo = 8 * 128;  // 8 rows of 128 bytes: one swizzle atom
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Tile::kQBytes;  // stage s: K at + 2 s kKV, V at + (2 s + 1) kKV

  const int q0 = blockIdx.x * kBlockRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;  // owns query rows q0 + 64 wg to q0 + 64 wg + 63
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const int n = a.n, dv = a.d;
  const bool vec = a.vec16 != 0;

  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + head * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + head * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + head * a.vs.h;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os.b + head * a.os.h;

  sm90::stage_tile<kBlockRows, kDP, kBlockThreads>(q_s, qb, a.qs.n, q0, n, dv, vec, tid);
  sm90::stage_tile<kWgBN, kDP, kBlockThreads>(kv_s, kb, a.ks.n, 0, n, dv, vec, tid);
  sm90::stage_tile<kWgBN, kDP, kBlockThreads>(kv_s + kKV, vb, a.vs.n, 0, n, dv, vec, tid);
  sm90::cp_async_commit();

  float o[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // rows g and g + 8
  // exp(scale (x - m)) = exp2(x scale log2(e) - m scale log2(e)): one FMA
  // and one ex2 a score
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const int col_lane = 2 * (lane % 4);

  const int tiles = (n + kWgBN - 1) / kWgBN;
  for (int t = 0; t < tiles; ++t) {
    // tile t (and Q) landed in this thread's writes; the barrier makes
    // everyone's visible and tells that tile t - 1's stage is free
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    __syncthreads();
    // the tile bases, opaque to the compiler so that it rebuilds each
    // descriptor with an add where it is used instead of holding all of
    // them (64 bits each) in registers across the loop
    uint32_t q_t = q_s + wg * kBM * 128, k_s = kv_s + 2 * (t & 1) * kKV;
    asm volatile("" : "+r"(q_t), "+r"(k_s));
    const uint32_t v_s = k_s + kKV;

    // S = Q K^T over HC / 16 steps of 16 columns: step kk starts 32 (kk % 4)
    // bytes into the 128-byte rows of the 64-column block kk / 4
    float s[kWgBN / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      const uint64_t da = sm90::sw128_desc(q_t + (kk / 4) * kBlockRows * 128 + col, 16, kSbo);
      const uint64_t db = sm90::sw128_desc(k_s + (kk / 4) * kWgBN * 128 + col, 16, kSbo);
      sm90::wgmma_ss_m64n64k16(s, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    // tile t + 1 loads into the other stage, issued while S multiplies
    if (t + 1 < tiles) {
      const uint32_t next = kv_s + 2 * ((t + 1) & 1) * kKV;
      const int row0 = (t + 1) * kWgBN;
      sm90::stage_tile<kWgBN, kDP, kBlockThreads>(next, kb, a.ks.n, row0, n, dv, vec, tid);
      sm90::stage_tile<kWgBN, kDP, kBlockThreads>(next + kKV, vb, a.vs.n, row0, n, dv, vec, tid);
      sm90::cp_async_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // online softmax on the accumulator layout: s[4j + e] is row g (e < 2)
    // or g + 8 (e >= 2), key t * kWgBN + 8j + col_lane + (e % 2)
    const int k0 = t * kWgBN;
    const bool ragged = k0 + kWgBN > n;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && k0 + 8 * j + col_lane + (e % 2) >= n) s[4 * j + e] = kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
      }
    float corr[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = sm90::ex2((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      ms[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sm90::ex2(fmaf(s[4 * j + e], scale_log2, -ms[e / 2]));
        rs[e / 2] += p;
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
    // p rounded to bf16: the A fragments of the kWgBN / 16 steps of P V
    uint32_t p[kWgBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i % 4) / 2];
      sm90::fence_regs(o[c]);
    }

    // O += P V: keys 16kk to 16kk + 15 are 2048 bytes into the V tile; one
    // m64n64k16 per 64-column block of V
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const uint64_t db = sm90::sw128_desc(v_s + c * kWgBN * 128 + kk * 16 * 128,
                                             kWgBN * 128, kSbo);
        sm90::wgmma_rs_m64n64k16<1>(o[c], p[kk], db, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kCB; ++c) sm90::fence_regs(o[c]);
  }

  // O / l, rounded to bf16; rows past n and columns past dv are not stored
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int g = q0 + kBM * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (row >= n) continue;
    // m is the row max of the unscaled logits: lse = m scale + ln(l)
    if (a.lse != nullptr && lane % 4 == 0)
      a.lse[((size_t)b * gridDim.y + head) * n + row] = m[half] * a.scale + logf(l[half]);
    bf16* dst = ob + (long long)row * a.os.n;
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + col_lane;
        const float v0 = o[c][4 * j + 2 * half] * inv[half];
        const float v1 = o[c][4 * j + 2 * half + 1] * inv[half];
        if (a.out_vec2 && col + 1 < dv) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < dv) dst[col] = __float2bfloat16(v0);
          if (col + 1 < dv) dst[col + 1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int HC>
cudaError_t launch_bf16(const AttnArgs& a, int batch, int heads, cudaStream_t stream) {
  auto kernel = attention_fwd_wgmma_kernel<HC>;
  constexpr size_t smem = WgmmaTile<HC>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + kBlockRows - 1) / kBlockRows, heads, batch);
  kernel<<<grid, kBlockThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------ head dims above 256: D in chunks

// Output columns a block (a chunk of D), both types: the bf16 accumulator of
// a 64 x DC chunk is DC / 2 registers a thread, as O is at the build for 256.
constexpr int kChunk = 256;

template <int DC>
struct ChunkedTile {
  static constexpr int kRing = chunked::Ring<kBlockRows>::kBytes;  // Q and K chunks
  static constexpr int kVBytes = kWgBN * DC * 2;                   // V's chunk of columns
  static constexpr size_t kSmem = kRing + kVBytes + 1024;
};

// bf16 at D > 256: the block of (query tile, column chunk) sums S over
// 64-column chunks of Q and K (chunked::contract) and accumulates only its DC
// columns of O; the softmax, the rounding of p and the tile order are those
// of attention_fwd_wgmma_kernel. Chunk 0 writes the lse.
template <int DC>
__global__ void __launch_bounds__(kBlockThreads)
attention_fwd_chunked_wgmma_kernel(const AttnArgs a) {
  using Tile = ChunkedTile<DC>;
  constexpr int kCB = DC / 64;
  constexpr uint32_t kSbo = 8 * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = ring + Tile::kRing;

  const int n = a.n, dv = a.d;
  const int chunks = (dv + DC - 1) / DC;
  const int q0 = (blockIdx.x / chunks) * kBlockRows;
  const int d0 = (blockIdx.x % chunks) * DC;  // this block's output columns d0 to d0 + DC - 1
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;  // owns query rows q0 + 64 wg to q0 + 64 wg + 63
  const int warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const bool vec = a.vec16 != 0;

  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + head * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + head * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + head * a.vs.h;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os.b + head * a.os.h;

  float o[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const int col_lane = 2 * (lane % 4);

  int step = 0;
  const int tiles = (n + kWgBN - 1) / kWgBN;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kWgBN;
    float s[kWgBN / 2];
    chunked::contract<kBlockRows, kBlockThreads>(
        s, ring, step, qb, a.qs.n, q0, kb, a.ks.n, k0, n, dv, vec, tid, wg, [&] {
          sm90::stage_tile<kWgBN, DC, kBlockThreads>(v_s, vb + d0, a.vs.n, k0, n, dv - d0, vec,
                                                     tid);
        });

    // the online softmax of attention_fwd_wgmma_kernel
    const bool ragged = k0 + kWgBN > n;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && k0 + 8 * j + col_lane + (e % 2) >= n) s[4 * j + e] = kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
      }
    float corr[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = sm90::ex2((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      ms[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sm90::ex2(fmaf(s[4 * j + e], scale_log2, -ms[e / 2]));
        rs[e / 2] += p;
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
    uint32_t p[kWgBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i % 4) / 2];
      sm90::fence_regs(o[c]);
    }

    // O += P V over this block's DC columns of V, staged by the contraction
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const uint64_t db = sm90::sw128_desc(v_s + c * kWgBN * 128 + kk * 16 * 128,
                                             kWgBN * 128, kSbo);
        sm90::wgmma_rs_m64n64k16<1>(o[c], p[kk], db, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kCB; ++c) sm90::fence_regs(o[c]);
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int g = q0 + kBM * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (row >= n) continue;
    if (a.lse != nullptr && d0 == 0 && lane % 4 == 0)
      a.lse[((size_t)b * gridDim.y + head) * n + row] = m[half] * a.scale + logf(l[half]);
    bf16* dst = ob + (long long)row * a.os.n;
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = d0 + 64 * c + 8 * j + col_lane;
        const float v0 = o[c][4 * j + 2 * half] * inv[half];
        const float v1 = o[c][4 * j + 2 * half + 1] * inv[half];
        if (a.out_vec2 && col + 1 < dv) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < dv) dst[col] = __float2bfloat16(v0);
          if (col + 1 < dv) dst[col + 1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int DC>
constexpr size_t chunked_smem_bytes() {
  constexpr int kS = chunked::kCols + 1;
  return sizeof(float) * (size_t)(kBM * kS + kBN * kS + kBN * DC + kBM * kPStride);
}

// f32 at D > 256: attention_fwd_kernel with S summed over 64-column chunks of
// q and k (restaged for every key tile) and O accumulated over the block's DC
// columns of v only. Chunk 0 writes the lse.
template <int DC>
__global__ void __launch_bounds__(kThreads)
attention_fwd_chunked_kernel(const AttnArgs a) {
  constexpr int kS = chunked::kCols + 1;  // padded row stride of the q and k chunks
  constexpr int kOC = DC / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // kBM x kS
  float* ks = qs + kBM * kS;      // kBN x kS
  float* vs = ks + kBN * kS;      // kBN x DC
  float* ps = vs + kBN * DC;      // kBM x kPStride

  const int n = a.n, dv = a.d;
  const int chunks = (dv + DC - 1) / DC;
  const int q0 = (blockIdx.x / chunks) * kBM;
  const int d0 = (blockIdx.x % chunks) * DC;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float scale = a.scale;

  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + head * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + head * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + head * a.vs.h;
  float* ob = static_cast<float*>(a.o) + b * a.os.b + head * a.os.h;
  const long long q_n = a.qs.n, k_n = a.ks.n, v_n = a.vs.n, o_n = a.os.n;
  const int warp = tid / 32, lane = tid % 32;

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
    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < dv; c0 += chunked::kCols) {
      // the previous chunk's readers (and the previous tile's, of vs and ps)
      // are done
      __syncthreads();
      for (int r = warp; r < kBM; r += kThreads / 32) {
        const int qrow = q0 + r, krow = k0 + r;
        const float* qsrc = qb + qrow * q_n + c0;
        const float* ksrc = kb + krow * k_n + c0;
#pragma unroll
        for (int d = lane; d < chunked::kCols; d += 32) {
          qs[r * kS + d] = (qrow < n && c0 + d < dv) ? qsrc[d] : 0.f;
          ks[r * kS + d] = (krow < n && c0 + d < dv) ? ksrc[d] : 0.f;
        }
        if (c0 == 0) {
          const float* vsrc = vb + krow * v_n + d0;
#pragma unroll
          for (int d = lane; d < DC; d += 32)
            vs[r * DC + d] = (krow < n && d0 + d < dv) ? vsrc[d] : 0.f;
        }
      }
      __syncthreads();
      tile_dot_nt_add(qs, ks, ty, tx, s);
    }

    // the online softmax of attention_fwd_kernel
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
        ps[(ty * kTR + i) * kPStride + tx + 16 * j] = p;
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
      for (int j = 0; j < kOC; ++j) vv[j] = vs[k * DC + tx + 16 * j];
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
    if (a.lse != nullptr && d0 == 0 && tx == 0)
      a.lse[((size_t)b * gridDim.y + head) * n + row] = m[i] + logf(l[i]);
    const float inv = 1.f / l[i];
    float* dst = ob + row * o_n;
#pragma unroll
    for (int j = 0; j < kOC; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < dv) dst[d] = o[i][j] * inv;
    }
  }
}

// a grid axis over the DC-column chunks of D: x = query tile * chunks + chunk
template <bool kBf16>
cudaError_t launch_chunked(const AttnArgs& a, int batch, int heads, cudaStream_t stream) {
  constexpr int kDC = kChunk;
  constexpr int kRows = kBf16 ? kBlockRows : kBM;
  constexpr size_t smem = kBf16 ? ChunkedTile<kDC>::kSmem : chunked_smem_bytes<kDC>();
  static_assert(smem <= 232448, "over a block's shared memory");
  void (*kernel)(const AttnArgs);
  if constexpr (kBf16) kernel = attention_fwd_chunked_wgmma_kernel<kDC>;
  else kernel = attention_fwd_chunked_kernel<kDC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (a.d + kDC - 1) / kDC;
  dim3 grid(((a.n + kRows - 1) / kRows) * chunks, heads, batch);
  kernel<<<grid, kBf16 ? kBlockThreads : kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16 at D > 256, N <= 1152: the P-resident route (attention_chunked.cuh)
__global__ void __launch_bounds__(resident::kBlockThreads, 1)
attention_fwd_resident_wgmma_kernel(const __grid_constant__ resident::Args a) {
  resident::run<true>(a);
}

// K1's views as the route's operands; grid x = query tile * split + part
cudaError_t launch_resident(const AttnArgs& a, int batch, int heads, int split,
                            cudaStream_t stream) {
  resident::Args r;
  std::memset(static_cast<void*>(&r), 0, sizeof(r));
  using bf16 = __nv_bfloat16;
  r.src[resident::kQ] = {static_cast<const bf16*>(a.q), a.qs.b, a.qs.h, a.qs.n};
  r.src[resident::kK] = {static_cast<const bf16*>(a.k), a.ks.b, a.ks.h, a.ks.n};
  r.src[resident::kV] = {static_cast<const bf16*>(a.v), a.vs.b, a.vs.h, a.vs.n};
  r.dst[0] = {static_cast<bf16*>(a.o), a.os.b, a.os.h, a.os.n};
  r.lse_out = a.lse;
  r.scale = a.scale;
  r.out_vec2 = a.out_vec2;
  if (!resident::prepare(r, a.n, a.d, heads, batch, split, 3, a.vec16 != 0))
    return cudaErrorInvalidValue;
  const size_t smem = resident::smem_bytes(r.tiles, r.slots);
  auto kernel = attention_fwd_resident_wgmma_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(r.tiles * split, heads, batch), resident::kBlockThreads, smem, stream>>>(r);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- dispatch

bool multiple_of(long long v, long long m) { return v % m == 0; }

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// bf16 views whose bases and strides are all multiples of 16 bytes, which
// 16-byte cp.async needs
bool views_16b(const AttnArgs& a) {
  const View views[3] = {a.qs, a.ks, a.vs};
  for (const View& s : views)
    if (!multiple_of(s.b, 8) || !multiple_of(s.h, 8) || !multiple_of(s.n, 8)) return false;
  return aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.v, 16);
}

template <bool kBf16, int HC>
cudaError_t launch(const AttnArgs& a, int batch, int heads, cudaStream_t s) {
  if constexpr (kBf16) return launch_bf16<HC>(a, batch, heads, s);
  else return launch_f32<HC>(a, batch, heads, s);
}

// the kernel built for the smallest head dim that holds a.d, or above 256 the
// chunked one: f32 on the CUDA cores, bf16 on the tensor cores
template <bool kBf16>
cudaError_t dispatch_head_dim(const AttnArgs& a, int batch, int heads, cudaStream_t s) {
  if (a.d <= 0) return cudaErrorInvalidValue;
  if (a.d <= 32) return launch<kBf16, 32>(a, batch, heads, s);
  if (a.d <= 64) return launch<kBf16, 64>(a, batch, heads, s);
  if (a.d <= 128) return launch<kBf16, 128>(a, batch, heads, s);
  if (a.d <= 192) return launch<kBf16, 192>(a, batch, heads, s);
  if (a.d <= 256) return launch<kBf16, 256>(a, batch, heads, s);
  return launch_chunked<kBf16>(a, batch, heads, s);
}

// dtype: 0 = float32, 1 = bfloat16. route 0: the head-dim builds (above 256
// the walk); 1: the P-resident route (bf16, D > 256, N <= 1152), its
// columns split over `split` blocks a query tile. A route that does not take
// the call is refused, never replaced.
int dispatch(AttnArgs a, int batch, int heads, int dtype, int route, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || heads <= 0 || a.n <= 0 || route < 0 || route > 1 ||
      (route == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_head_dim<false>(a, batch, heads, s);
  if (dtype == 1) {
    a.vec16 = views_16b(a);
    a.out_vec2 = aligned(a.o, 4) && multiple_of(a.os.b, 2) && multiple_of(a.os.h, 2) &&
                 multiple_of(a.os.n, 2);
    if (route == 1) return (int)launch_resident(a, batch, heads, split, s);
    return (int)dispatch_head_dim<true>(a, batch, heads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1. qkv is (batch, n, 3c) and out is (batch, n, c), both contiguous on the
// current device. lse, when not null, is an f32 (batch, num_heads, n) that
// receives each row's log-sum-exp of the scaled logits, ln sum_j exp(scale
// q k_j), which K2 takes. route and split as dispatch's. Returns the CUDA
// error code of the launch (0 on success).
int nd_fused_qkv_attention_routed(const void* qkv, void* out, float* lse, int batch, int n,
                                  int c, int num_heads, int split_first, int dtype, float scale,
                                  int route, int split, void* stream) {
  if (num_heads <= 0 || c % num_heads != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long hc = c / num_heads, c3 = 3LL * c;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  // [q(C) | k(C) | v(C)] when split_first, else per head [h0:(q|k|v) | h1:...]
  const long long part = split_first ? c : hc;        // from q to k, from k to v
  const View in = {(long long)n * c3, split_first ? hc : 3 * hc, c3};
  const char* base = static_cast<const char*>(qkv);
  AttnArgs a = {};
  a.q = base;
  a.k = base + part * elem;
  a.v = base + 2 * part * elem;
  a.o = out;
  a.lse = lse;
  a.qs = a.ks = a.vs = in;
  a.os = {(long long)n * c, hc, c};
  a.n = n;
  a.d = (int)hc;
  a.scale = scale;
  return dispatch(a, batch, num_heads, dtype, route, split, stream);
}

// K5. q, k and v are (batch, heads, n, d) views with the given element
// strides of their batch, head and row axes (the last axis contiguous); out
// is a contiguous (batch, heads, n, d). route and split as dispatch's.
// Returns the CUDA error code.
int nd_mha_attention_routed(const void* q, const void* k, const void* v, void* out, int batch,
                            int heads, int n, int d, const long long* q_strides,
                            const long long* k_strides, const long long* v_strides, int dtype,
                            float scale, int route, int split, void* stream) {
  AttnArgs a = {};
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
  return dispatch(a, batch, heads, dtype, route, split, stream);
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
