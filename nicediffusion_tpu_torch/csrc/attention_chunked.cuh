// Head dims above 256 (attention.cu, attention_bwd.cu): K1/K5 and K2, which
// replace the TPU kernels of nicediffusion_tpu/ops/pallas/attention.py
// (pallas_call :177, :486 and :334) at those head dims. On this card the
// tensor cores bound them (K1: 2 N^2 D flops a head against 4 N D bytes).
// A 64 x D f32
// accumulator is past 255 registers a thread at D = 512, so no warpgroup
// holds a whole head row of the output: the output is made in chunks of its
// columns, and every contraction over D (S = Q K^T, dP = G V^T and their
// transposes) is summed over 64-column chunks of D in chunk order. A chunk of
// 64 bf16 columns is one 128-byte swizzle atom a row (sm90.cuh), so the
// descriptors are those of the builds for D <= 256: a K-major operand one
// 64-column block wide, four k16 steps 32 bytes apart. Two routes, chosen on
// the host from N and D by a plan (ops/kernels/attention.py ::
// chunked_attention_plan; this header's kNLimit is its N limit):
//
// The walk (chunked::contract, the first schedule; f32 always, bf16 above the
// N limit). A grid axis runs over 256-column chunks of the output; the block
// of (row tile, chunk) makes the logits (and K2's dP) over all of D again,
// streamed through a two-stage cp.async ring behind a block barrier, and
// keeps only its chunk of the output. Every block of a row tile makes the same
// sums in the same order, so their S and p agree bit for bit. The price: S
// made once per output chunk, (ceil(D / 256) + 1) / 2 of K1's products.
//
// The P-resident route (resident::, bf16, N <= kNLimit). A block owns one
// 64-row tile of one (batch, head) and keeps the bf16 result of the
// elementwise step (p, or K2's dS) of every tile pair in shared memory, so it
// makes the logits once per (row tile, other tile) pair:
//   pass 1, over the other side's 64-row tiles: S (and dP) summed over the
//     64-column chunks of D in chunk order, as the walk sums them; then the
//     walk's elementwise arithmetic (K1: the online softmax with the running
//     row max, its correction and the row sum; K2: p from K1's log-sum-exp,
//     dS = p (dP - delta) scale); the bf16 tile goes into shared memory in
//     the K-major 128-byte swizzle that wgmma reads as A, K1's correction and
//     row sum per row beside it;
//   pass 2, over the output's 64-column blocks (at most four a warpgroup at
//     once, 128 registers): per tile, K1 rescales by the tile's correction,
//     then acc += X_t B_t with A = X_t by descriptor. The sums of every output
//     element are the walk's, in the walk's order, with the same roundings:
//     the results are the walk's bit for bit (wgmma with A from shared memory
//     gives the register-A products).
// A block is three warpgroups: a producer (setmaxnreg 56) that fills a ring
// of 16 KB stages (two 64 x 64 blocks) by TMA (4-D tensor maps over (D, N,
// heads, batch), 64 x 64 boxes in the 128-byte swizzle, zeros past N and D)
// under full and empty mbarriers, or where a view allows no 16-byte copy by
// 2-byte loads of all its threads. Each consumer warpgroup has its own full
// barrier a slot: a phase wait names a phase by its parity only, so a barrier
// waited on by two warpgroups in turn would let the one that runs ahead pass
// on the phase before last (a fill still in flight) and release a stage that
// the other still reads. Two consumer warpgroups (224 registers)
// that share the row tile: in pass 1 they take alternate tiles (K1 hands the
// running row max from one to the other through shared memory and an mbarrier
// pair, so the softmax keeps its order), in pass 2 alternate column blocks.
// Each stage is consumed by one warpgroup, which keeps one wgmma group in
// flight and releases the stage before last; the warpgroup index is
// broadcast from lane 0, so that ptxas sees the branches on it uniform and
// does not serialize the wgmma they guard. Pass 1 -> 2 is one barrier of the
// two consumers. What paces the route is the stage's fixed cost: with
// neither loads nor products a stage still takes about 250 cycles of a block
// (PERF.md). A plan may split a tile's column blocks over several
// blocks that each repeat pass 1 (small grids); no split changes a bit.
// Shared memory: a 1 KB alignment, 4 to 8 stages, per tile 8 KB of X and 512
// bytes of f32 (K1: correction, row sum; K2's dk and dv blocks: the query
// rows' lse and delta), 512 bytes of K1's handoff and the barriers (full per
// consumer and slot, empty per slot, K1's two handoff ones); N is limited
// where 4 stages no longer fit: kNLimit = 1152.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "attention_common.cuh"
#include "sm90.cuh"

namespace nd {
namespace chunked {

constexpr int kCols = 64;            // columns of D a step of a contraction
constexpr uint32_t kSbo = 8 * 128;   // 8 rows of 128 bytes: one swizzle atom

// The walk's ring: two stages, each an A chunk (A_ROWS x 64) then a B chunk (64 x 64).
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

// ------------------------------------------------------ the P-resident route

namespace resident {

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kBlockThreads = kConsumers + kWgThreads;  // two consumers, one producer
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // 128 x 56 + 256 x 224 <= 65536
constexpr int kBlock = 64 * 128;           // a 64 x 64 bf16 block in the 128-byte swizzle
constexpr int kSlot = 2 * kBlock;          // a ring stage
constexpr int kStatTile = 2 * 64 * 4;      // two f32 a row (or a column) of a tile
constexpr int kTileBytes = kBlock + kStatTile;
constexpr int kHandoff = 2 * 64 * 4;       // K1: the running row max of two tiles
constexpr int kMinSlots = 4, kMaxSlots = 8;
constexpr int kBarBytes = 8 * (3 * kMaxSlots + 2);  // full[2][slots], empty[slots], ready[2]
constexpr int kFixed = 1024 + kHandoff + kBarBytes;
constexpr int kSmemMax = 232448;
constexpr int kMaxTiles = (kSmemMax - kFixed - kMinSlots * kSlot) / kTileBytes;
constexpr int kNLimit = 64 * kMaxTiles;    // 1152
constexpr int kMaxCb = 4;                  // 64-column output blocks a warpgroup holds at once
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kNLimit == 1152, "the plan in ops/kernels/attention.py names this limit");

enum Role { kFwd = 0, kDq = 1, kDk = 2, kDv = 3 };
enum Op { kQ = 0, kK = 1, kV = 2, kG = 3 };

// a bf16 (batch, heads, n, d) view: element strides of the batch, head and
// row axes, the last axis contiguous
struct Operand {
  const bf16* p;
  long long b, h, n;
};

struct Out {
  bf16* p;
  long long b, h, n;
};

struct Args {
  CUtensorMap map[4];  // q, k, v, g by TMA (tma = 1)
  Operand src[4];      // q, k, v, g
  Out dst[3];          // K1: the output; K2: dq, dk, dv
  const float* lse_in;  // K2: K1's row log-sum-exp, (batch, heads, n)
  float* lse_out;       // K1: null, or the row log-sum-exp it writes
  const float* delta;   // K2: rowsum(g o), (batch, heads, n)
  int n, d, tiles, slots, split, cblocks;
  float scale;
  int tma, out_vec2;
};

// the operands of a role: the two contractions' own (a) and streamed (b)
// operands (a2 < 0: one contraction) and pass 2's streamed one
struct Ops {
  int a1, b1, a2, b2, p2;
};

__host__ __device__ constexpr Ops role_ops(int role) {
  if (role == kFwd) return {kQ, kK, -1, -1, kV};    // S = Q K^T; O = P V
  if (role == kDq) return {kQ, kK, kG, kV, kK};     // S, dP = G V^T; dQ = dS K
  if (role == kDk) return {kK, kQ, kV, kG, kQ};     // S^T, dP^T = V G^T; dK = dS^T Q
  return {kK, kQ, -1, -1, kG};                      // S^T; dV = P^T G
}

// a block: its role, its own row tile and its part of the output's columns.
// x = (role index * tiles + tile) * split + part; K2's roles dq, dk, dv
struct Block {
  int role, tile, part;
};

__device__ __forceinline__ Block decode(const Args& a, bool k1) {
  const int x = blockIdx.x;
  const int part = x % a.split, rest = x / a.split;
  return {k1 ? (int)kFwd : 1 + rest / a.tiles, rest % a.tiles, part};
}

// 64-column blocks [lo, lo + n) of the output
struct Span {
  int lo, n;
};

// a part's blocks, in rounds of at most 2 kMaxCb, each round halved between
// the two consumer warpgroups
struct Columns {
  int lo, hi, rounds;
  __device__ __forceinline__ Columns(const Args& a, int part)
      : lo(part * a.cblocks / a.split), hi((part + 1) * a.cblocks / a.split),
        rounds((hi - lo + 2 * kMaxCb - 1) / (2 * kMaxCb)) {}
  __device__ __forceinline__ Span span(int r, int wg) const {
    const int q = (hi - lo + rounds - 1) / rounds;
    const int r_lo = lo + r * q, r_hi = min(r_lo + q, hi);
    const int m = max(r_hi - r_lo, 0), n0 = (m + 1) / 2;
    return wg == 0 ? Span{r_lo, n0} : Span{r_lo + n0, m - n0};
  }
};

// one 64 x 64 block of operand `op` (rows row0.., columns col0..) into the
// swizzled block at dst: by TMA (one thread) or by 2-byte loads (all 128
// producer threads); zeros past n and d either way
__device__ __forceinline__ void load_block(const Args& a, int op, int b, int h, int row0,
                                           int col0, uint32_t dst, uint32_t bar, int ptid) {
  if (a.tma) {
    sm90::tma_load_4d(dst, &a.map[op], bar, col0, row0, h, b);
  } else {
    const Operand& s = a.src[op];
    sm90::stage_tile<64, 64, kWgThreads>(dst, s.p + b * s.b + h * s.h + col0, s.n, row0, a.n,
                                         a.d - col0, false, ptid);
  }
}

// The producer: every stage of the block in the consumers' order, by one
// thread (TMA) or all 128 (2-byte loads); a stage for consumer w completes
// full[w][slot].
__device__ __forceinline__ void produce(const Args& a, const Block& blk, int b, int h,
                                        uint32_t ring, uint32_t full, uint32_t empty, int ptid) {
  const Ops ops = role_ops(blk.role);
  const int chunks = a.cblocks, steps = chunks * (ops.a2 >= 0 ? 2 : 1);
  int slot = 0, phase = 0;
  // waits for the slot; the caller loads `blocks` blocks into it; then the
  // full barrier of consumer w is told
  auto stage = [&](int w, int blocks, auto&& load) {
    const uint32_t st = ring + (uint32_t)(slot * kSlot),
                   bar = full + 8u * (uint32_t)(w * kMaxSlots + slot);
    sm90::mbar_wait(empty + 8u * slot, phase ^ 1);
    if (a.tma) sm90::mbar_arrive_expect_tx(bar, blocks * kBlock);
    load(st, bar);
    if (!a.tma) {
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar);
    }
    if (++slot == a.slots) slot = 0, phase ^= 1;
  };
  const int pairs = (a.tiles + 1) / 2;
#pragma unroll 1
  for (int p = 0; p < pairs; ++p)
#pragma unroll 1
    for (int k = 0; k < steps; ++k)
#pragma unroll 1
      for (int w = 0; w < 2; ++w) {
        const int t = 2 * p + w;
        if (t >= a.tiles) continue;
        const bool second = k >= chunks;
        const int c = second ? k - chunks : k;
        stage(w, 2, [&](uint32_t st, uint32_t bar) {
          load_block(a, second ? ops.a2 : ops.a1, b, h, 64 * blk.tile, 64 * c, st, bar, ptid);
          load_block(a, second ? ops.b2 : ops.b1, b, h, 64 * t, 64 * c, st + kBlock, bar, ptid);
        });
      }
  const Columns cols(a, blk.part);
#pragma unroll 1
  for (int r = 0; r < cols.rounds; ++r)
#pragma unroll 1
    for (int t = 0; t < a.tiles; ++t)
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll 1
        for (int w = 0; w < 2; ++w) {
          const Span s = cols.span(r, w);
          if (2 * hh >= s.n) continue;
          const int blocks = min(2, s.n - 2 * hh);
          stage(w, blocks, [&](uint32_t st, uint32_t bar) {
            for (int j = 0; j < blocks; ++j)
              load_block(a, ops.p2, b, h, 64 * t, 64 * (s.lo + 2 * hh + j), st + j * kBlock, bar,
                         ptid);
          });
        }
}

// acc (+)= A B^T over one 64-column chunk: A and B K-major 64 x 64 blocks
__device__ __forceinline__ void chunk_product(float (&acc)[32], uint32_t at, uint32_t bt,
                                              bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss_m64n64k16(acc, sm90::sw128_desc(at + 32 * kk, 16, chunked::kSbo),
                             sm90::sw128_desc(bt + 32 * kk, 16, chunked::kSbo),
                             accumulate || kk > 0);
}

// a warpgroup's packed bf16 tile (the A fragments of its four k16 steps:
// rows g + 8 (r % 2), columns 16 kk + 8 (r / 2) + col_lane + {0, 1}) into a
// K-major 64 x 64 block in the 128-byte swizzle
__device__ __forceinline__ void store_tile(uint32_t tile, int g, int col_lane,
                                           const uint32_t (&v)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r % 2), chunk = 2 * kk + r / 2;
      sm90::st_shared_b32(tile + row * 128 + ((chunk ^ (row & 7)) << 4) + 2 * col_lane,
                          v[kk][r]);
    }
}

// The consumers of a block of role kRole (K1's, or one of K2's). wg is the
// warpgroup, broadcast from lane 0 so that the compiler sees it uniform
// across a warp: its branches are not divergent, and the wgmma it guards are
// not serialized.
template <int kRole>
__device__ __forceinline__ void consume(const Args& a, const Block& blk, int b, int h,
                                        uint32_t ring, uint32_t full, uint32_t empty,
                                        uint32_t xs, float* stats, float* handoff,
                                        uint32_t ready, int tid, int wg) {
  constexpr bool kK1 = kRole == kFwd;
  constexpr bool kTwo = role_ops(kRole).a2 >= 0;  // two contractions in pass 1
  const int wtid = tid % kWgThreads;
  const int warp = wtid / 32, lane = tid % 32;
  const int chunks = a.cblocks, steps = chunks * (kTwo ? 2 : 1);
  const int n = a.n, own0 = 64 * blk.tile, tiles = a.tiles;
  const int g = 16 * warp + lane / 4;  // this thread's rows g and g + 8 of a 64-row tile
  const int col_lane = 2 * (lane % 4);
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  const size_t stat = ((size_t)b * gridDim.y + h) * n;

  // the ring's slot, and per slot the parity of this warpgroup's next phase
  // of its own full barrier
  int slot = 0, prev = -1;
  uint32_t parity = 0;
  const uint32_t mine_full = full + 8u * (uint32_t)(wg * kMaxSlots);
  auto advance = [&] {
    if (++slot == a.slots) slot = 0;
  };
  auto acquire = [&] {
    sm90::mbar_wait(mine_full + 8u * slot, (parity >> slot) & 1u);
    parity ^= 1u << slot;
    if (!a.tma) sm90::fence_proxy_async();
  };
  // after a group is issued: one left in flight, the stage before released
  auto issued = [&] {
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (prev >= 0 && wtid == 0) sm90::mbar_arrive(empty + 8u * prev);
    prev = slot;
    advance();
  };
  auto drain = [&] {
    sm90::wgmma_wait<0>();
    if (prev >= 0 && wtid == 0) sm90::mbar_arrive(empty + 8u * prev);
    prev = -1;
  };

  // K2's per-row values: dq's own rows by register; dk's and dv's query
  // rows (the columns of their tiles), every tile's, in shared memory (rows
  // past n: lse = inf, so p = 0)
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if constexpr (!kK1) {
    if constexpr (kRole == kDq) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = own0 + g + 8 * i;
        lse2[i] = row < n ? a.lse_in[stat + row] * kLog2e : 0.f;
        dlt[i] = row < n ? a.delta[stat + row] : 0.f;
      }
    } else {
      for (int i = tid; i < tiles * 128; i += kConsumers) {
        const int t = i / 128, j = i % 128, row = 64 * t + j % 64;
        float v;
        if (j < 64) v = row < n ? a.lse_in[stat + row] * kLog2e : __int_as_float(0x7f800000);
        else v = row < n ? a.delta[stat + row] : 0.f;
        stats[128 * t + j] = v;
      }
      sm90::named_barrier(1, kConsumers);
    }
  }

  // ---- pass 1: the warpgroups take alternate tiles of the other side
  const int pairs = (tiles + 1) / 2;
#pragma unroll 1
  for (int p = 0; p < pairs; ++p) {
    const int t = 2 * p + wg;
    const bool mine = t < tiles, other = 2 * p + 1 - wg < tiles;
    float s[32], dp[32];
    uint32_t pk[4][4];
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w != wg) {
          if (other) advance();
          continue;
        }
        if (!mine) continue;
        const bool second = kTwo && k >= chunks;
        const int c = second ? k - chunks : k;
        acquire();
        uint32_t at = ring + (uint32_t)(slot * kSlot);
        asm volatile("" : "+r"(at));
        sm90::wgmma_fence();
        if (second) chunk_product(dp, at, at + kBlock, c > 0);
        else chunk_product(s, at, at + kBlock, c > 0);
        issued();
        if (c + 1 < chunks) continue;
        drain();
        const uint32_t xt = xs + (uint32_t)(t * kBlock);
        float* st = stats + 128 * t;
        if (!second) {
          sm90::fence_regs(s);
          if constexpr (kK1) {
            // the online softmax of the walk: the running row max comes from
            // the warpgroup of tile t - 1 and goes to that of tile t + 1
            const int k0 = 64 * t;
            const bool ragged = k0 + 64 > n;
            float mx[2] = {kMasked, kMasked};
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (ragged && k0 + 8 * j + col_lane + (e % 2) >= n) s[4 * j + e] = kMasked;
                mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
              }
            float mp[2] = {kMasked, kMasked};
            if (t > 0) {
              sm90::mbar_wait(ready + 8u * ((t - 1) & 1), ((t - 1) >> 1) & 1);
#pragma unroll
              for (int i = 0; i < 2; ++i) mp[i] = handoff[64 * ((t - 1) & 1) + g + 8 * i];
            }
            float corr[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
              mx[i] = fmaxf(mp[i], mx[i]);
              if (lane % 4 == 0) handoff[64 * (t & 1) + g + 8 * i] = mx[i];
            }
            sm90::mbar_arrive(ready + 8u * (t & 1));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              corr[i] = sm90::ex2((mp[i] - mx[i]) * scale_log2);
              ms[i] = mx[i] * scale_log2;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float pv = sm90::ex2(fmaf(s[4 * j + e], scale_log2, -ms[e / 2]));
                rs[e / 2] += pv;
                s[4 * j + e] = pv;
              }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
              rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
              if (lane % 4 == 0) {
                st[g + 8 * i] = corr[i];
                st[64 + g + 8 * i] = rs[i];
              }
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                pk[kk][r] = sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            store_tile(xt, g, col_lane, pk);
          } else if constexpr (kRole == kDq) {
            // p = exp(scale s - lse), keys past n at 0, rounded to bf16 in pairs
            const int k0 = 64 * t;
            const bool ragged = k0 + 64 > n;
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
          } else {
            // p^T = exp(scale s - lse[query]), rounded to bf16 in pairs
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
                const float2 l2 = *reinterpret_cast<const float2*>(st + col);
                pk[kk][r] = sm90::pack_bf16x2(sm90::ex2(fmaf(s[i], scale_log2, -l2.x)),
                                              sm90::ex2(fmaf(s[i + 1], scale_log2, -l2.y)));
              }
            if constexpr (kRole == kDv) store_tile(xt, g, col_lane, pk);
          }
        } else {
          sm90::fence_regs(dp);
          // ds = p (dp - delta) scale from the rounded p, rounded to bf16 (dk:
          // transposed, delta by query column)
          uint32_t ds[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 8 * kk + 2 * r, col = 16 * kk + 8 * (r / 2) + col_lane;
              float d0, d1;
              if constexpr (kRole == kDq) {
                d0 = d1 = dlt[r % 2];
              } else {
                const float2 d2 = *reinterpret_cast<const float2*>(st + 64 + col);
                d0 = d2.x;
                d1 = d2.y;
              }
              ds[kk][r] = sm90::pack_bf16x2(sm90::bf16_lo(pk[kk][r]) * (dp[i] - d0) * scale,
                                            sm90::bf16_hi(pk[kk][r]) * (dp[i + 1] - d1) * scale);
            }
          store_tile(xt, g, col_lane, ds);
        }
      }
    }
  }
  // the tiles' stores are read by wgmma (the async proxy) past this barrier
  sm90::fence_proxy_async();
  sm90::named_barrier(1, kConsumers);

  // ---- pass 2: the output's column blocks, alternate ones a warpgroup
  const Columns cols(a, blk.part);
#pragma unroll 1
  for (int r = 0; r < cols.rounds; ++r) {
    const Span mine = cols.span(r, wg), theirs = cols.span(r, 1 - wg);
    float acc[kMaxCb][32];
#pragma unroll
    for (int cb = 0; cb < kMaxCb; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
      if (kK1 && mine.n > 0) {
        // the tile's correction of the running max, once the last tile's
        // products are done
        drain();
        const float c0 = stats[128 * t + g], c1 = stats[128 * t + g + 8];
#pragma unroll
        for (int cb = 0; cb < kMaxCb; ++cb) {
          sm90::fence_regs(acc[cb]);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[cb][i] *= (i % 4) / 2 ? c1 : c0;
          sm90::fence_regs(acc[cb]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const Span s = w == wg ? mine : theirs;
          if (2 * hh >= s.n) continue;
          if (w != wg) {
            advance();
            continue;
          }
          acquire();
          uint32_t st = ring + (uint32_t)(slot * kSlot), xt = xs + (uint32_t)(t * kBlock);
          asm volatile("" : "+r"(st), "+r"(xt));
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (2 * hh + j < s.n)
                sm90::wgmma_ss_m64n64k16_mn(
                    acc[2 * hh + j], sm90::sw128_desc(xt + 32 * kk, 16, chunked::kSbo),
                    sm90::sw128_desc(st + j * kBlock + kk * 16 * 128, 64 * 128, chunked::kSbo), 1);
          issued();
        }
    }
    drain();
#pragma unroll
    for (int cb = 0; cb < kMaxCb; ++cb) sm90::fence_regs(acc[cb]);
    if (mine.n == 0) continue;

    // the epilogue: rows past n and columns past d are not stored
    float inv[2] = {1.f, 1.f}, l[2] = {0.f, 0.f};
    const Out& out = a.dst[kK1 ? 0 : kRole - 1];
    if (kK1) {
      for (int t = 0; t < tiles; ++t)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          l[i] = l[i] * stats[128 * t + g + 8 * i] + stats[128 * t + 64 + g + 8 * i];
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = own0 + g + 8 * half;
      if (row >= n) continue;
      if (kK1 && a.lse_out != nullptr && mine.lo == 0 && lane % 4 == 0) {
        // the final running max is the last tile's handoff
        const float m = handoff[64 * ((tiles - 1) & 1) + g + 8 * half];
        a.lse_out[stat + row] = m * a.scale + logf(l[half]);
      }
      bf16* dst = out.p + b * out.b + h * out.h + (long long)row * out.n;
#pragma unroll
      for (int cb = 0; cb < kMaxCb; ++cb) {
        if (cb >= mine.n) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * (mine.lo + cb) + 8 * j + col_lane;
          float v0 = acc[cb][4 * j + 2 * half], v1 = acc[cb][4 * j + 2 * half + 1];
          if (kK1) {
            v0 *= inv[half];
            v1 *= inv[half];
          }
          if (a.out_vec2 && col + 1 < a.d) {
            *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < a.d) dst[col] = __float2bfloat16(v0);
            if (col + 1 < a.d) dst[col + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// The whole block: barriers, then the producer or a consumer.
template <bool kK1>
__device__ __forceinline__ void run(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t xs = ring + (uint32_t)(a.slots * kSlot);
  const uint32_t stats_s = xs + (uint32_t)(a.tiles * kBlock);
  const uint32_t hand_s = stats_s + (uint32_t)(a.tiles * kStatTile);
  const uint32_t full = hand_s + kHandoff, empty = full + 8 * 2 * kMaxSlots,
                 ready = empty + 8 * kMaxSlots;
  float* stats = reinterpret_cast<float*>(smem_raw + (stats_s - raw));
  float* handoff = reinterpret_cast<float*>(smem_raw + (hand_s - raw));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < a.slots; ++i) {
      for (int w = 0; w < 2; ++w)
        sm90::mbar_init(full + 8u * (w * kMaxSlots + i), a.tma ? 1u : (uint32_t)kWgThreads);
      sm90::mbar_init(empty + 8u * i, 1);  // each stage has one consumer warpgroup
    }
    sm90::mbar_init(ready, kWgThreads);
    sm90::mbar_init(ready + 8u, kWgThreads);
    sm90::fence_mbarrier_init();
  }
  __syncthreads();
  const Block blk = decode(a, kK1);
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  if (wg == 2) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (a.tma && tid != kConsumers) return;
    produce(a, blk, b, h, ring, full, empty, tid - kConsumers);
    return;
  }
  sm90::setmaxnreg_inc<kConsumerRegs>();
  if constexpr (kK1) {
    consume<kFwd>(a, blk, b, h, ring, full, empty, xs, stats, handoff, ready, tid, wg);
  } else if (blk.role == kDq) {
    consume<kDq>(a, blk, b, h, ring, full, empty, xs, stats, handoff, ready, tid, wg);
  } else if (blk.role == kDk) {
    consume<kDk>(a, blk, b, h, ring, full, empty, xs, stats, handoff, ready, tid, wg);
  } else {
    consume<kDv>(a, blk, b, h, ring, full, empty, xs, stats, handoff, ready, tid, wg);
  }
}

// ---- host side

inline int slots_for(int tiles) {
  const int s = (kSmemMax - kFixed - tiles * kTileBytes) / kSlot;
  return s > kMaxSlots ? kMaxSlots : s;
}

inline size_t smem_bytes(int tiles, int slots) {
  return (size_t)kFixed + (size_t)slots * kSlot + (size_t)tiles * kTileBytes;
}

// the most blocks a row tile's columns may be split over: two 64-column
// blocks a part at least
inline int max_split(int d) {
  const int cb = (d + 63) / 64;
  return cb / 2 > 1 ? cb / 2 : 1;
}

// a 4-D map over an operand (d, n, heads, batch) in 64 x 64 boxes in the
// 128-byte swizzle; loads give zeros out of bounds
inline bool encode(CUtensorMap* map, const Operand& o, int n, int d, int heads, int batch) {
  const sm90::EncodeTiled fn = sm90::tensor_map_encoder();
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * (cuuint64_t)o.n, 2ull * (cuuint64_t)o.h,
                                 2ull * (cuuint64_t)o.b};
  const cuuint32_t box[4] = {64, 64, 1, 1}, ones[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(o.p), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// fills the shape fields of a (the caller sets the views, scale and
// outputs), checks the plan, and where tma and every stride of the first
// `ops` operands is positive encodes their maps; false on what the route
// does not take
inline bool prepare(Args& a, int n, int d, int heads, int batch, int split, int ops, bool tma) {
  const int tiles = (n + 63) / 64;
  if (d <= 256 || n <= 0 || tiles > kMaxTiles || split < 1 || split > max_split(d)) return false;
  a.n = n;
  a.d = d;
  a.tiles = tiles;
  a.slots = slots_for(tiles);
  a.split = split;
  a.cblocks = (d + 63) / 64;
  for (int i = 0; i < ops && tma; ++i) {
    const Operand& o = a.src[i];
    tma = o.b > 0 && o.h > 0 && o.n > 0;
  }
  a.tma = tma;
  for (int i = 0; i < ops && tma; ++i)
    if (!encode(&a.map[i], a.src[i], n, d, heads, batch)) return false;
  return a.slots >= kMinSlots;
}

}  // namespace resident
}  // namespace nd
