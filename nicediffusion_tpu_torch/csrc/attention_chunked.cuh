// Head dims above 256 (attention.cu, attention_bwd.cu): a head row no longer
// fits one tile, so every contraction over D (S = Q K^T, dP = G V^T and their
// transposes) is summed over 64-column chunks of D that stream through a
// two-stage ring, and a block accumulates only one chunk of the output's
// columns (a grid axis over output chunks). The blocks of one row tile run
// the same contraction in the same order, so their S, softmax and p agree
// bit for bit with no communication between them.
//
// A chunk of 64 bf16 columns is one 128-byte swizzle atom a row (sm90.cuh),
// so the descriptors are those of the builds for D <= 256: a K-major operand
// one 64-column block wide, four k16 steps 32 bytes apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace nd {
namespace chunked {

constexpr int kCols = 64;            // columns of D a step of a contraction
constexpr uint32_t kSbo = 8 * 128;   // 8 rows of 128 bytes: one swizzle atom

// The ring: two stages, each an A chunk (A_ROWS x 64) then a B chunk (64 x 64).
template <int A_ROWS>
struct Ring {
  static constexpr int kABytes = A_ROWS * kCols * 2;
  static constexpr int kStage = kABytes + 64 * kCols * 2;
  static constexpr int kBytes = 2 * kStage;
};

// acc = the sum over the 64-column chunks c of D of A_c B_c^T: A is rows
// [a0, a0 + A_ROWS) and B rows [b0, b0 + 64) of two bf16 views (row strides
// lda and ldb, n rows of d elements: rows past n and columns past d land as
// zeros), and this warpgroup (wg) multiplies its 64 rows of A by the 64 of B.
// Chunk c goes into stage `step & 1` of the ring at `ring`, `step` being the
// block's count of ring steps, which the call advances by the number of
// chunks; chunk c + 1 loads while chunk c multiplies. Every step starts with a
// barrier of the block; past it the stage of the next load is free (its last
// reader was the step before the last, whose wgmma every warpgroup waited
// for), and so is the caller's product operand, which `first` stages in the
// group of chunk 1 (it is in shared memory by the barrier of chunk 1's step).
// The chunk count, (d + 63) / 64, is at least 2 (d > 256 here).
template <int A_ROWS, int THREADS, typename First>
__device__ __forceinline__ void contract(float (&acc)[32], uint32_t ring, int& step,
                                         const __nv_bfloat16* a, long long lda, int a0,
                                         const __nv_bfloat16* b, long long ldb, int b0, int n,
                                         int d, bool vec, int tid, int wg, First first) {
  using R = Ring<A_ROWS>;
  const int chunks = (d + kCols - 1) / kCols;
  auto stage = [&](int s, int c) {
    const uint32_t at = ring + (s & 1) * R::kStage;
    const int cols = d - c * kCols;  // columns of this chunk and after it
    sm90::stage_tile<A_ROWS, kCols, THREADS>(at, a + c * kCols, lda, a0, n, cols, vec, tid);
    sm90::stage_tile<64, kCols, THREADS>(at + R::kABytes, b + c * kCols, ldb, b0, n, cols, vec,
                                         tid);
  };
  stage(step, 0);
  sm90::cp_async_commit();
  for (int c = 0; c < chunks; ++c, ++step) {
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    __syncthreads();
    // the stage's bases, opaque to the compiler, so that it rebuilds each
    // descriptor where it is used instead of holding them across the loop
    uint32_t at = ring + (step & 1) * R::kStage + wg * 64 * 128;
    uint32_t bt = ring + (step & 1) * R::kStage + R::kABytes;
    asm volatile("" : "+r"(at), "+r"(bt));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_m64n64k16(acc, sm90::sw128_desc(at + 32 * kk, 16, kSbo),
                               sm90::sw128_desc(bt + 32 * kk, 16, kSbo), c > 0 || kk > 0);
    sm90::wgmma_commit();
    if (c + 1 < chunks) stage(step + 1, c + 1);
    if (c == 0) first();
    sm90::cp_async_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }
}

}  // namespace chunked
}  // namespace nd
