// Hopper (sm_90a) building blocks written in PTX: shared-memory matrix
// descriptors for the 128-byte swizzle, warpgroup matrix multiplies
// (wgmma.mma_async, bf16 in, f32 accumulate) and 16-byte cp.async with
// zero fill, a tile stager and ex2. The bf16 attention kernels (attention.cu,
// attention_bwd.cu) are built from them.
//
// Layout. A tile of R rows and a multiple of 64 bf16 columns is stored as
// 64-column blocks one after another, each R x 128 bytes, row r at r * 128
// bytes, with the 16-byte chunk c of a row at chunk c ^ (r % 8): the
// 128-byte swizzle (Swizzle<3,4,3>) that a descriptor with layout type 1
// names. Eight rows make one 1024-byte swizzle atom, so every tile starts on
// a 1024-byte boundary. The same layout serves as a K-major operand (rows
// are M or N, the 64 columns are K) and as an MN-major one (rows are K, the
// 64 columns are N).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nd {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk `chunk` of row r in a swizzled tile of
// `rows` rows
__device__ __forceinline__ uint32_t sw128_offset(int r, int chunk, int rows) {
  return (uint32_t)((chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
}

// matrix descriptor of a 128-byte-swizzled operand starting at shared
// address `addr`: lbo and sbo in bytes (sbo: from one 8-row group to the
// next; lbo: from one 64-column block to the next of an MN-major operand,
// unused by a K-major one), layout type 1 (128-byte swizzle), base offset 0
// (every start lies on a 1024-byte atom or 32, 64 or 96 bytes into its
// first row)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// tells the compiler that the registers change here, so it moves no read
// or write of an accumulator across an asynchronous multiply's issue or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 to 16) are written as zeros and not read. Both addresses are
// 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_16(uint32_t dst, uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w0), "r"(w1),
               "r"(w2), "r"(w3)
               : "memory");
}

// orders this thread's shared-memory writes (stores and cp.async) before
// later reads by the async proxy, which wgmma reads its operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages rows [row0, row0 + ROWS) of a bf16 view (n rows of dv elements,
// row stride ld) into a swizzled ROWS x DP tile at shared address dst, with
// THREADS threads: rows past n and columns past dv as zeros. vec: 16-byte
// cp.async (the caller commits the group); otherwise 2-byte loads and
// 16-byte shared stores.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                           int row0, int n, int dv, bool vec, int tid) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  // a loop left rolled, so that no address of a later pass is held in a
  // register across the multiplies
#pragma unroll 1
  for (int id = tid; id < ROWS * kChunks; id += THREADS) {
    const int r = id / kChunks, chunk = id % kChunks;
    const int row = row0 + r, col = chunk * 8;
    const uint32_t at = dst + sw128_offset(r, chunk, ROWS);
    const int valid = row < n ? min(max(dv - col, 0), 8) : 0;  // elements from memory
    const __nv_bfloat16* p = src + (long long)row * ld + col;
    if (vec) {
      cp_async_16(at, valid > 0 ? p : src, 2 * valid);
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < valid) w[j / 2] |= (uint32_t)e[j] << (16 * (j % 2));
      st_shared_16(at, w[0], w[1], w[2], w[3]);
    }
  }
}

// 2^x on the multifunction unit; a result under 2^-126 flushes to zero,
// 2^-inf is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 halves of a packed register as floats (exact)
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// The warpgroup multiplies. A warpgroup is 128 threads; warp w of it owns
// rows 16w to 16w + 15 of the 64-row tile, and lane l of that warp rows
// g = 16w + l / 4 and g + 8, at columns 2 (l % 4) and 2 (l % 4) + 1 of
// every 8-column group. The f32 accumulator of an m64nN product is N / 2
// registers: d[4j], d[4j+1] at row g, columns 8j + 2 (l % 4) + {0, 1};
// d[4j+2], d[4j+3] at row g + 8, the same columns. A 16-bit A fragment
// (m64k16, from registers) is 4 registers of two values each: rows g,
// g + 8, g, g + 8 at columns 2 (l % 4) + {0, 1}, then + 8; so an
// accumulator's columns 16k to 16k + 15 are the A fragment of step k once
// packed in pairs (d[8k..8k+7] -> a[0..3]).

// d (+)= A B, A and B both from shared memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B, A from registers (a 16-bit A fragment), B from shared memory
// through a descriptor: K-major for kTransB = 0, MN-major for kTransB = 1
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

}  // namespace sm90
}  // namespace nd
