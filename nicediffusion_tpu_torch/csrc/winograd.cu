// The Winograd F(2x2, 3x3) convolution of a bf16 forward with grad mode off
// (DiffusionModel(winograd=True)): one launch a call, the input transform,
// the 16 products on the tensor cores (wgmma, bf16 in, f32 sums) and the
// output transform fused, with an order of sums that no batch, row, batch
// mate or grid changes.
//
// Replaces no Pallas kernel. The JAX package computes
// nicediffusion_tpu/ops/winograd.py::winograd_conv_3x3 (:63) as an XLA
// composition: 4x4 tile gathers, the transforms as einsums, 16 batched
// dot_generals with f32 sums, each intermediate in device memory. Its header
// records that on a v5e this lost to the direct conv (4.8x over a forward),
// from those gathers, transposes and f32 intermediates. Here V and M never
// leave the multiprocessors.
//
// For x (B, H, W, C) NHWC bf16, u (16, F, C) bf16 (U = G g G^T of each
// filter, position p = 4 i + l, channels innermost; the wrapper makes it) and
// an optional bias (F,) f32 it computes, per 4x4 tile d of the input
// SAME-padded by one (and by zeros to even H and W) at stride 2:
//   V = B^T d B                in bf16: the rows (B^T d) rounded, then the
//                              columns rounded (ops/winograd.py, bit for bit)
//   M_p = sum_c V_p[c] U_p[c]  f32 sums (exact bf16 products)
//   Y = A^T M A                f32, rows first, each sum left to right
//   out = bf16(Y + bias)       the 2x2 outputs, those past H and W dropped
// Order of sums: every element of M sums C in 32-channel steps in ascending
// order, two k16 halves a step (one wgmma each, whose inner order is fixed
// whatever its n), A^T M A in one fixed f32 sequence, then the bias and one
// rounding. Nothing splits C, and a tile is one row of each product whatever
// its neighbours: the bits are a function of the tile alone, equal to the
// first build's (64 tiles x 32 filters a block, 16 m64n16 products) at
// every shape. The grid follows the batch, the order does not.
//
// What bounds it. Operations: 2 * 16 * C * F per tile (4 outputs) against
// 2 (C + F) bytes a pixel: hundreds of operations a byte at the UNets'
// widths, above the card's ~295 for bf16 at 989 TFLOP/s and 3.35 TB/s, so
// the tensor cores' rate, at 4/9 of the direct conv's products. The first
// build reached 7% of it: the threads that issued the products also loaded
// the pixels, made V and staged U, unhidden; and its 16 m64n16 products (one
// a position, all 16 in one block) read a 2 KB A for a 512-byte B, so shared
// memory alone (V written 64 KB, U 32 KB, 160 KB read a 32-channel step of
// 2.10 MFLOP: ~2,000 cycles at 128 bytes a cycle against the tensor cores'
// ~512) held that layout near 25% even with the staging hidden.
//
// The design: the 16 positions split over a thread-block cluster of four,
// producer warpgroups beside two consumer warpgroups that only multiply, and
// M traded through distributed shared memory for the output transform.
//   Work unit: 64 tiles (of all examples, numbered in one sequence) x FT
//   filters, FT = 128 or 64 from F alone (winograd_filter_tile: the one with
//   fewer shared-memory bytes over the padded filters, 128 on a tie). A
//   cluster of 4 blocks takes one unit; block r makes row r of V = B^T d B,
//   positions 4 r to 4 r + 3, for which it needs only 2 of a tile's 4 pixel
//   rows (B^T's row r: d0 - d2, d1 + d2, d2 - d1, d1 - d3).
//   Block: 512 threads. A ring of three 32-channel stages (V 4 positions x 64
//   tiles x 64 bytes, U 4 x FT x 64 bytes, both K-major in the 64-byte
//   swizzle) and four raw slots (a step's pixel rows). Two producer
//   warpgroups (setmaxnreg 72) take alternate steps: a thread makes V of two
//   tiles' 8 channels from the raw rows with the first build's fma.rn.bf16x2
//   transform and stores it; each warp arrives once on the stage's full
//   barriers. The consumers (setmaxnreg 184) issue every TMA while their
//   products run: U of step s + 3 (a 3-D map over (16, F, C), each warpgroup
//   its own two positions, into the stage it has just freed) and the rows of
//   step s + 4 (a 4-D map over x, a box of one pixel row's 2 tw + 2 pixels a
//   thread, into the slot the producers read at step s). Warpgroup w holds
//   positions 4 r + 2 w and 4 r + 2 w + 1 as two m64nFT accumulators (128
//   f32 registers at FT = 128), issues four wgmma a stage (A = V, B = U, both
//   by descriptor) and frees the stage when they are done. Each stage has one
//   full mbarrier for each consumer warpgroup (a parity wait shared by two
//   warpgroups can pass on a fill in flight) and one empty barrier. Where no
//   tensor map fits x (C not a multiple of 8, maps over 254 wide, a unit's
//   rows over a slot) the producers load their pixels themselves; where none
//   fits U (the stems) they copy it.
//   Epilogue: a cluster barrier (every block's ring is free), each consumer
//   thread stores its M values, 16 bytes at a time (st.shared::cluster), into
//   the block that finishes their tiles (warp w's 16 tiles: a quarter), a
//   second cluster barrier, then A^T M A from the block's own shared memory,
//   the bias, one rounding, bf16 pairs out. No persistent blocks: a cluster
//   a unit.
//   Edges stay zero-filled: tiles past the last (the grid's tail), pixels
//   outside the map, channels past C (C of 1 and 3), filters past F (the
//   tensor maps' out-of-bounds fill, or the copies').
//
// The accounting, per block and 32-channel step at FT = 128 (2.10 MFLOP):
// shared memory V written 16 KB, U 32 KB, read 48 KB (each consumer its two
// positions' V and U once): 96 KB, ~770 cycles at 128 bytes a cycle against
// the tensor cores' ~512, a ceiling near 67% of the bound (FT = 64: 64 KB a
// 1.05 MFLOP step, ~50%). From L2 a block reads 32 KB of U and 32 KB of
// pixels a step (about half of them L1 hits: neighbouring tiles share two
// columns), ~40-60 bytes a cycle at the tensor rate: the L2's ~30-40 a
// multiprocessor caps the products nearer 40%. The epilogue trades 128 KB of
// M (96 KB of it remote) a unit, a few thousand cycles against 12 steps at C
// = 384. Prediction (written before the first run on the card, PERF.md
// §6): about 28% of the bound over the 73 convs of an openai_64 forward,
// 38 ms at model batch 128 (range 30-50) and 6.0 ms at 16 (4.5-8, a smaller
// grid), 1.07x the direct bf16 conv at 128 (35.6018 ms) and 0.79x cuDNN
// (47.9899 ms).
// Measured on an H100 (PERF.md §6): about 15% of the bound, 72 ms at
// model batch 128 and 10 ms at 16, half the first build's time. The pixel
// rows staged through shared memory (the first layout's loads from each
// producer thread were bound by their issue) add ~50 KB a step to the 96:
// ~145 KB, ~1,100 cycles at 128 bytes a cycle, and a block spends about a
// third of its life outside the main loop (a cluster barrier, the M trade,
// another barrier, the output transform: ~14,000 cycles at C = 384) and
// ~4,000 cycles filling the ring (clock64 traces of one cluster).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "conv_common.cuh"
#include "sm90.cuh"

namespace {

namespace sm90 = nd::sm90;
using bf16 = __nv_bfloat16;

constexpr int kCluster = 4;          // blocks a cluster: block r makes row r of V
constexpr int kRowPos = 4;           // positions a block: 4 r to 4 r + 3
constexpr int kPos = 16;             // transform positions
constexpr int kWgThreads = 128;
constexpr int kConsumers = 2 * kWgThreads;  // two consumer warpgroups
constexpr int kProducers = 2 * kWgThreads;  // two producer warpgroups
constexpr int kBlock = kConsumers + kProducers;
constexpr int kProducerRegs = 72, kConsumerRegs = 184;  // 256 x 72 + 256 x 184 <= 512 x 128
constexpr int kTiles = 64;           // Winograd tiles a unit: wgmma's M
constexpr int kStepC = 32;           // channels a step: one 64-byte row
constexpr int kVPos = kTiles * 64;   // one position's V of a step: 4096 bytes
constexpr int kV = kRowPos * kVPos;  // a stage's V
constexpr int kItems = kTiles * kStepC / 8 / kWgThreads;  // (tile, chunk) items a thread a step
static_assert(kItems == 2, "a producer thread makes V of two tiles' 8 channels a step");
constexpr int kRawMax = 20 * 1024;   // a raw slot: a step's pixel rows (TMA boxes)
constexpr int kRawSlots = 4;         // raw slots: two a producer warpgroup

template <int FT>
struct Ring {
  static constexpr int kUPos = FT * 64;          // one position's U of a step
  static constexpr int kU = kRowPos * kUPos;
  static constexpr int kStage = kV + kU;         // V and U of a step
  static constexpr int kStages = 3;              // one multiplied, two filling
  static constexpr int kRing = kStages * kStage;  // then the raw slots
  // M of a quarter's 16 tiles, [position][tile % 8][filter / 8][filter % 8 /
  // 2][tile / 8][filter % 2] f32: a consumer's four values of a filter pair
  // and tiles g, g + 8 side by side (one 16-byte store); a tile % 8 row of
  // FT * 8 bytes and 64 more, so that a warp's 8 rows spread over the banks
  static constexpr int kMRow = FT * 8 + 64;
  static constexpr int kMPos = kTiles / kCluster / 2 * kMRow;
  static_assert(kPos * kMPos <= kRing + kRawSlots * kRawMax, "M fits in the ring");
  static constexpr size_t kSmem =
      1024 + kRing + kRawSlots * kRawMax + 8 * (3 * kStages + kRawSlots);
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

struct Args {
  CUtensorMap map_u;  // TMA: U as (C, F, 16), boxes of (32 channels, FT filters, 2 positions)
  CUtensorMap map_x;  // TMA: x as (C, W, H, B), boxes of one pixel row's 2 tw + 2 pixels
  const bf16* x;
  const bf16* u;
  const float* bias;  // null: no bias
  bf16* out;
  int h, w, c, f;
  int th, tw;         // tile rows and columns of a map
  int steps;          // 32-channel steps
  int ftiles;         // filter tiles of FT
  long long tiles;    // batch * th * tw
  int vec_x, vec_u;   // 16-byte loads allowed (C % 8 = 0, 16-byte bases)
  int tma;            // 1: U by TMA; 0: by the producer's cp.async
  int tma_x;          // 1: pixel rows by TMA; 0: by the producer's loads
  int box_tx;         // bytes of one pixel-row box, (2 tw + 2) x 64
  int box_bytes;      // its place in the raw rows, on 128 bytes
};

// a + b and a - b of two bf16 pairs, each rounded once to bf16 (the exact
// sum, as torch's bf16 addition gives: f32 holds the sum of two bf16 values)
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

__device__ __forceinline__ uint4 add8(const uint4& a, const uint4& b) {
  return make_uint4(badd(a.x, b.x), badd(a.y, b.y), badd(a.z, b.z), badd(a.w, b.w));
}

__device__ __forceinline__ uint4 sub8(const uint4& a, const uint4& b) {
  return make_uint4(bsub(a.x, b.x), bsub(a.y, b.y), bsub(a.z, b.z), bsub(a.w, b.w));
}

// A producer item's tile: the pixel of its (row 0, column 0) over all
// examples (possibly outside the map) and which of its 4 rows and 4 columns
// lie inside (none for a tile past the last)
struct TileIn {
  long long pix0;
  uint32_t rows, cols;
};

__device__ __forceinline__ TileIn tile_in(const Args& a, long long t) {
  TileIn tile{0, 0u, 0u};
  if (t < a.tiles) {
    const long long per = (long long)a.th * a.tw, b = t / per;
    const int rem = (int)(t - b * per), ty = rem / a.tw, tx = rem - ty * a.tw;
    const int y0 = 2 * ty - 1, x0 = 2 * tx - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (y0 + j >= 0 && y0 + j < a.h) tile.rows |= 1u << j;
      if (x0 + j >= 0 && x0 + j < a.w) tile.cols |= 1u << j;
    }
    tile.pix0 = (b * a.h + y0) * a.w + x0;
  }
  return tile;
}

// 8 channels from c on of tile pixel (j, k): zeros outside the map or past C
__device__ __forceinline__ uint4 load_px(const Args& a, const TileIn& t, int j, int k, int c) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!((t.rows >> j) & (t.cols >> k) & 1u) || c >= a.c) return zero;
  const bf16* p = a.x + (t.pix0 + (long long)j * a.w + k) * a.c + c;
  if (a.vec_x) return __ldg(reinterpret_cast<const uint4*>(p));
  return nd::conv::load_bytes(p, 2 * min(a.c - c, 8));
}

// the rows of a tile's 4 x 4 input that row r of B^T d reads (B^T's row r:
// d0 - d2, d1 + d2, d2 - d1, d1 - d3)
__device__ __forceinline__ int row_a(int r) { return r == 2 ? 2 : r == 0 ? 0 : 1; }
__device__ __forceinline__ int row_b(int r) { return r == 2 ? 1 : r == 3 ? 3 : 2; }

// Those two rows of a tile, 8 channels from c on, from device memory: d[k]
// of row row_a(r), d[4 + k] of row row_b(r) (the producer's loads, where no
// tensor map fits)
__device__ __forceinline__ void load_rows(uint4 (&d)[8], const Args& a, const TileIn& tile, int c,
                                          int r) {
  const int ja = row_a(r), jb = row_b(r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = load_px(a, tile, ja, k, c);
    d[4 + k] = load_px(a, tile, jb, k, c);
  }
}

// Row r of B^T d from those rows, each column rounded: the first build's
// operations
__device__ __forceinline__ uint4 row_op(const uint4& da, const uint4& db, int r) {
  return r == 1 ? add8(da, db) : sub8(da, db);
}

// Row r of B^T d of a tile from the raw rows a TMA box pair holds: pixel k
// of row row_a(r) at `at` + 64 k, of row row_b(r) one box further. A tile
// at an odd column reads its columns in the order 1, 0, 3, 2, so that a
// warp's 8 tiles fall on both halves of the banks, and swaps them back.
__device__ __forceinline__ void read_row(uint4 (&t)[4], uint32_t at, int box_bytes, bool odd,
                                         int r) {
  uint4 tp[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t px = at + (uint32_t)(64 * (k ^ (int)odd));
    tp[k] = row_op(sm90::ld_shared_16(px), sm90::ld_shared_16(px + (uint32_t)box_bytes), r);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = odd ? tp[k ^ 1] : tp[k];
}

// Row r of V from row r of B^T d (t): V[r][l] = (t B)[l], each rounded, into
// the stage's four position slots at vst + off
__device__ __forceinline__ void store_v(uint32_t vst, uint32_t off, const uint4 (&t)[4]) {
  const uint32_t at = vst + off;
  const uint4 v0 = sub8(t[0], t[2]), v1 = add8(t[1], t[2]);
  const uint4 v2 = sub8(t[2], t[1]), v3 = sub8(t[1], t[3]);
  sm90::st_shared_16(at, v0.x, v0.y, v0.z, v0.w);
  sm90::st_shared_16(at + kVPos, v1.x, v1.y, v1.z, v1.w);
  sm90::st_shared_16(at + 2 * kVPos, v2.x, v2.y, v2.z, v2.w);
  sm90::st_shared_16(at + 3 * kVPos, v3.x, v3.y, v3.z, v3.w);
}

// U of positions p0 to p0 + 3 at step `step`, filters f0 to f0 + FT - 1, into
// the stage at ust by the producer warpgroup's cp.async (byte loads where no
// 16-byte copy is aligned); filters past F and channels past C as zeros. The
// caller waits and fences.
template <int FT>
__device__ __forceinline__ void stage_u(uint32_t ust, const Args& a, int f0, int p0, int step,
                                        int ptid) {
  constexpr int kPer = FT * 4;  // 16-byte chunks of a position
#pragma unroll 1
  for (int id = ptid; id < kRowPos * kPer; id += kWgThreads) {
    const int l = id / kPer, rem = id - l * kPer, fr = rem >> 2, q = rem & 3;
    const int fl = f0 + fr, c = step * kStepC + 8 * q;
    const int valid = fl < a.f ? min(max(a.c - c, 0), 8) : 0;
    const bf16* src = valid > 0 ? a.u + ((size_t)(p0 + l) * a.f + fl) * a.c + c : a.u;
    nd::conv::copy_chunk(ust + (uint32_t)(l * Ring<FT>::kUPos) + sm90::sw64_offset(fr, q), src,
                         2 * valid, a.vec_u);
  }
}

template <int FT>
__device__ __forceinline__ void wgmma_ss(float (&d)[FT / 2], uint64_t a, uint64_t b) {
  if constexpr (FT == 64) sm90::wgmma_ss_m64n64k16_bf16(d, a, b, 1);
  if constexpr (FT == 128) sm90::wgmma_ss_m64n128k16_bf16(d, a, b, 1);
}

// Y = A^T M A of one (tile, filter)'s 16 products m[4 i + l], rows first,
// each sum left to right: A^T's rows are (1, 1, 1, 0) and (0, 1, -1, -1)
__device__ __forceinline__ void output_transform(const float (&m)[kPos], float (&y)[2][2]) {
  float s[2][4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    s[0][l] = __fadd_rn(__fadd_rn(m[l], m[4 + l]), m[8 + l]);
    s[1][l] = __fsub_rn(__fsub_rn(m[4 + l], m[8 + l]), m[12 + l]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    y[i][0] = __fadd_rn(__fadd_rn(s[i][0], s[i][1]), s[i][2]);
    y[i][1] = __fsub_rn(__fsub_rn(s[i][1], s[i][2]), s[i][3]);
  }
}

// The producer warpgroups: warpgroup g makes V of the steps s = g mod 2,
// each thread two tiles' 8 channels (tiles gtid / 4 and 32 + gtid / 4 of the
// unit, chunk gtid % 4), so that the two warpgroups' steps overlap. No
// barrier among the threads and no loads to issue (the consumers issue the
// TMA): at step s a thread waits for the stage (freed by the consumers at
// step s - 3) and for the step's raw pixel rows, reads each tile's two rows
// of the 4 x 4 input (row_a(rank) and row_b(rank)), makes row rank of V and
// stores it; its warp arrives once on the two full barriers. Where no
// tensor map fits x, a thread loads its pixels itself, and where none fits
// U, the warpgroup copies it.
template <int FT>
__device__ __forceinline__ void produce(const Args& a, uint32_t ring, uint32_t full, uint32_t empty,
                                        uint32_t rawb, int rank, long long t0, int f0, int ptid) {
  using R = Ring<FT>;
  const int g = ptid / kWgThreads, gtid = ptid % kWgThreads, q = gtid & 3, lane = gtid & 31;
  const long long r0 = t0 / a.tw;  // the unit's first tile row (tile t: row t / tw)
  long long tile[kItems];
  uint32_t off[kItems], raw[kItems];
  bool odd[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    tile[i] = t0 + 32 * i + (gtid >> 2);
    const long long row = tile[i] / a.tw;
    const int tx = (int)(tile[i] - row * a.tw);
    off[i] = sm90::sw64_offset(32 * i + (gtid >> 2), q);
    raw[i] = (uint32_t)(2 * (row - r0) * a.box_bytes + 128 * tx + 16 * q);
    odd[i] = tx & 1;
  }
#pragma unroll 1
  for (int s = g; s < a.steps; s += 2) {
    const int slot = s % R::kStages;
    const uint32_t st = ring + (uint32_t)(slot * R::kStage), bar = full + 16u * slot;
    sm90::mbar_wait(empty + 8u * slot, ((s / R::kStages) & 1) ^ 1);
    if (!a.tma) stage_u<FT>(st + kV, a, f0, kRowPos * rank, s, gtid);  // however x comes
    if (a.tma_x) {
      const int rs = s % kRawSlots;
      const uint32_t rows = ring + (uint32_t)(R::kRing + rs * kRawMax);
      sm90::mbar_wait(rawb + 8u * rs, (s / kRawSlots) & 1);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        uint4 tr[4];  // row rank of B^T d
        if (tile[i] < a.tiles) {
          read_row(tr, rows + raw[i], a.box_bytes, odd[i], rank);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) tr[k] = make_uint4(0u, 0u, 0u, 0u);
        }
        store_v(st, off[i], tr);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        uint4 d[8], tr[4];
        load_rows(d, a, tile_in(a, tile[i]), s * kStepC + 8 * q, rank);
#pragma unroll
        for (int k = 0; k < 4; ++k) tr[k] = row_op(d[k], d[4 + k], rank);
        store_v(st, off[i], tr);
      }
    }
    if (!a.tma) {
      sm90::cp_async_commit();
      sm90::cp_async_wait_all();
    }
    sm90::fence_proxy_async();  // V's stores (and U's copies) before the products read them
    __syncwarp();  // then one arrival for the warp (the raw slot's reads are done too)
    if (lane == 0) {
      sm90::mbar_arrive(bar);
      sm90::mbar_arrive(bar + 8u);
    }
  }
}

// The loads a consumer thread issues by TMA: its warpgroup's half of U of a
// step (thread 0 of the warpgroup: positions 4 rank + 2 wg and + 1, on the
// warpgroup's own full barrier), and the pixel-row box it owns (box 8 (tid
// % 32) + tid / 32 < nbox, spread over the warps: row row_a(rank) (even) or
// row_b(rank) (odd) of the unit's tile row box / 2) on the raw slot's
// barrier.
template <int FT>
struct Loads {
  const Args& a;
  uint32_t ring, full, rawb;
  int rank, f0, wg, box, box_y, box_b;
  bool u, rows;

  __device__ __forceinline__ Loads(const Args& a_, uint32_t ring_, uint32_t full_, uint32_t rawb_,
                                   int rank_, long long t0, int f0_, int tid, int nbox)
      : a(a_), ring(ring_), full(full_), rawb(rawb_), rank(rank_), f0(f0_) {
    wg = tid / kWgThreads;
    box = 8 * (tid % 32) + tid / 32;
    u = a.tma && tid % kWgThreads == 0;
    rows = a.tma_x && box < nbox;
    const long long row = t0 / a.tw + box / 2, b = row / a.th;
    box_b = (int)b;
    box_y = 2 * (int)(row - b * a.th) - 1 + ((box & 1) ? row_b(rank) : row_a(rank));
  }

  __device__ __forceinline__ void issue_u(int n) const {  // into a stage this warpgroup freed
    if (!u) return;
    const int slot = n % Ring<FT>::kStages;
    const uint32_t bar = full + 16u * slot + 8u * wg;
    sm90::mbar_arrive_expect_tx(bar, 2 * Ring<FT>::kUPos);
    sm90::tma_load_3d(ring + (uint32_t)(slot * Ring<FT>::kStage + kV + wg * 2 * Ring<FT>::kUPos),
                      &a.map_u, bar, n * kStepC, f0, kRowPos * rank + 2 * wg);
  }

  __device__ __forceinline__ void issue_rows(int n) const {  // into a slot the producers read
    if (!rows) return;
    const int slot = n % kRawSlots;
    sm90::mbar_arrive_expect_tx(rawb + 8u * slot, (uint32_t)a.box_tx);
    sm90::tma_load_4d(ring + (uint32_t)(Ring<FT>::kRing + slot * kRawMax + box * a.box_bytes),
                      &a.map_x, rawb + 8u * slot, n * kStepC, -1, box_y, box_b);
  }
};

template <int FT>
__global__ void __launch_bounds__(kBlock, 1)
    winograd_conv_cluster_wgmma_kernel(const __grid_constant__ Args a) {
  using R = Ring<FT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  // barriers: full [stage][consumer], empty [stage], raw rows landed [raw slot]
  const uint32_t full = ring + R::kRing + kRawSlots * kRawMax, empty = full + 16 * R::kStages;
  const uint32_t rawb = empty + 8 * R::kStages;
  const int tid = threadIdx.x, rank = sm90::cluster_rank();
  const long long unit = sm90::cluster_index();
  const long long mt = unit / a.ftiles;
  const int f0 = (int)(unit - mt * a.ftiles) * FT;
  const long long t0 = mt * kTiles;
  // the unit's pixel-row boxes: two a tile row its tiles span
  const int nbox = 2 * (int)((min(t0 + kTiles, a.tiles) - 1) / a.tw - t0 / a.tw + 1);
  if (tid == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      sm90::mbar_init(full + 16u * i, kWgThreads / 32 + a.tma);  // a warpgroup's warps (+ U)
      sm90::mbar_init(full + 16u * i + 8u, kWgThreads / 32 + a.tma);
      sm90::mbar_init(empty + 8u * i, 2);  // one a consumer warpgroup
    }
    for (int i = 0; i < kRawSlots; ++i) sm90::mbar_init(rawb + 8u * i, nbox);  // the boxes
    sm90::fence_mbarrier_init();
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform and
  // does not serialize the wgmma its addresses feed
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  const int wtid = tid % kWgThreads, warp = wtid / 32, lane = tid % 32;
  if (wg >= 2) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    produce<FT>(a, ring, full, empty, rawb, rank, t0, f0, tid - kConsumers);
    sm90::cluster_arrive();  // the two cluster barriers of the consumers' epilogue
    sm90::cluster_wait();
    sm90::cluster_arrive();
    sm90::cluster_wait();
    return;
  }
  // the consumers: the first stages' U and raw slots' rows, then a step at a
  // time the products and, while they run, the loads of later steps
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const Loads<FT> loads(a, ring, full, rawb, rank, t0, f0, tid, nbox);
  for (int n = 0; n < R::kStages && n < a.steps; ++n) loads.issue_u(n);
  for (int n = 0; n < kRawSlots && n < a.steps; ++n) loads.issue_rows(n);
  // the epilogue's outputs, found while the first loads land: this block's
  // quarter of the unit's tiles, a filter pair a thread and pass; where each
  // goes, its bias
  constexpr int kOwn = kTiles / kCluster;  // the tiles a block finishes: a quarter
  constexpr int kPairs = FT / 2, kPasses = kOwn * kPairs / kConsumers;
  static_assert(kPasses * kConsumers == kOwn * kPairs, "whole passes");
  long long dst[kPasses];  // output element of (row 0, column 0, filter fc); -1: none
  uint32_t edge[kPasses];  // bit i: row i inside the map, bit 2 + l: column l
  float2 bias[kPasses];
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    const int idx = it * kConsumers + tid;
    const long long t = t0 + kOwn * rank + idx / kPairs;
    const int fc = f0 + 2 * (idx % kPairs);
    dst[it] = -1, edge[it] = 0u, bias[it] = make_float2(0.f, 0.f);
    if (t >= a.tiles || fc >= a.f) continue;
    const long long per = (long long)a.th * a.tw, b = t / per;
    const int rem = (int)(t - b * per), ty = rem / a.tw, tx = rem - ty * a.tw;
    dst[it] = ((b * a.h + 2 * ty) * a.w + 2 * tx) * a.f + fc;
    edge[it] = (2 * ty + 1 < a.h ? 2u : 0u) | 1u | 4u | (2 * tx + 1 < a.w ? 8u : 0u);
    if (a.bias != nullptr)
      bias[it] = make_float2(a.bias[fc], fc + 1 < a.f ? a.bias[fc + 1] : 0.f);
  }
  float acc[2][FT / 2];
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int e = 0; e < FT / 2; ++e) acc[pp][e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < a.steps; ++s) {
    // positions 2 wg and 2 wg + 1 of the block, k16 halves in order: A = V
    // (the unit's 64 tiles), B = U (the FT filters), both by descriptor; the
    // stage goes back once its group is done, and takes this warpgroup's U
    // of step s + 3. The full barrier also says that the producers have read
    // the raw slot of step s: it takes the rows of step s + 4.
    const int slot = s % R::kStages;
    sm90::mbar_wait(full + 16u * slot + 8u * wg, (s / R::kStages) & 1);
    uint32_t vb = ring + (uint32_t)(slot * R::kStage + wg * 2 * kVPos);
    uint32_t ub = ring + (uint32_t)(slot * R::kStage + kV + wg * 2 * R::kUPos);
    asm volatile("" : "+r"(vb), "+r"(ub));
    sm90::wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss<FT>(acc[pp], sm90::sw64_desc(vb + pp * kVPos + kk * 32),
                     sm90::sw64_desc(ub + pp * R::kUPos + kk * 32));
    sm90::wgmma_commit();
    if (s + kRawSlots < a.steps) loads.issue_rows(s + kRawSlots);
    sm90::wgmma_wait<0>();
    if (wtid == 0) sm90::mbar_arrive(empty + 8u * slot);
    if (s + R::kStages < a.steps) loads.issue_u(s + R::kStages);
  }
  sm90::fence_regs(acc[0]);
  sm90::fence_regs(acc[1]);
  sm90::cluster_arrive();  // every block's products are done: its ring may take M
  sm90::cluster_wait();

  // M into the block that finishes its tiles: acc[pp][4 j + 2 h + e] is tile
  // g + 8 h (g = 16 warp + lane / 4: warp w holds quarter w), filter 8 j + 2
  // (lane % 4) + e of position 4 rank + 2 wg + pp, stored into block warp's M
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    const uint32_t at = sm90::map_shared_rank(
        ring + (uint32_t)((kRowPos * rank + 2 * wg + pp) * R::kMPos + (lane / 4) * R::kMRow +
                          16 * (lane % 4)),
        warp);
#pragma unroll
    for (int j = 0; j < FT / 8; ++j)
      sm90::st_cluster_f32x4(at + (uint32_t)(64 * j), acc[pp][4 * j], acc[pp][4 * j + 1],
                             acc[pp][4 * j + 2], acc[pp][4 * j + 3]);
  }
  sm90::cluster_arrive();  // every block's quarter of M has arrived
  sm90::cluster_wait();

  // the 16 positions of each output's tile and filter pair, A^T M A, the
  // bias, one rounding
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    if (dst[it] < 0) continue;
    const int idx = it * kConsumers + tid, row = idx / kPairs, fp = idx % kPairs;
    float2 mv[kPos];
#pragma unroll
    for (int p = 0; p < kPos; ++p)
      mv[p] = sm90::ld_shared_f32x2(ring + (uint32_t)(p * R::kMPos + (row % 8) * R::kMRow +
                                                      16 * fp + 8 * (row / 8)));
    const bool two = f0 + 2 * fp + 1 < a.f;
    float y[2][2][2];  // [e][i][l]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m[kPos];
#pragma unroll
      for (int p = 0; p < kPos; ++p) m[p] = e ? mv[p].y : mv[p].x;
      output_transform(m, y[e]);
      if (a.bias != nullptr) {
        const float bv = e ? bias[it].y : bias[it].x;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int l = 0; l < 2; ++l) y[e][i][l] = __fadd_rn(y[e][i][l], bv);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (!((edge[it] >> i) & (edge[it] >> (2 + l)) & 1u)) continue;
        bf16* out = a.out + dst[it] + ((size_t)i * a.w + l) * a.f;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y[0][i][l], y[1][i][l]);
        } else {
          out[0] = __float2bfloat16_rn(y[0][i][l]);
          if (two) out[1] = __float2bfloat16_rn(y[1][i][l]);
        }
      }
  }
}

// the filter tile of a call: of 128 and 64, the one whose shared-memory bytes
// a step (V 32 KB and U FT / 2 KB, written and read) over the padded filters
// are fewer, 128 on a tie. From F alone: never the batch. The wrapper's plan
// (ops/kernels/winograd.py::winograd_filter_tile) reads this rule as it is
// written here (tests/test_torch_winograd.py holds the two equal).
int winograd_filter_tile(int f) {
  return (f + 63) / 64 * 64 < (f + 127) / 128 * 96 ? 64 : 128;
}

// the most tile rows a unit's 64 tiles span: a unit starts at tile 64 m, so
// 64 m mod tw is a multiple of g = gcd(64, tw), at most tw - g
int unit_rows(int tw) {
  int g = 64;
  while (tw % g != 0) g /= 2;
  return (tw - g + kTiles - 1) / tw + 1;
}

template <int FT>
cudaError_t launch_ft(Args& a, int batch, long long units, cudaStream_t stream) {
  using R = Ring<FT>;
  const cuuint64_t cb = 2ull * a.c;
  if (a.tma) {  // U (16, F, C) as (C, F, 16), boxes of two positions' FT x 32
    const cuuint64_t dims[3] = {(cuuint64_t)a.c, (cuuint64_t)a.f, (cuuint64_t)kPos};
    const cuuint64_t strides[2] = {cb, cb * a.f};
    const cuuint32_t box[3] = {kStepC, FT, 2};
    if (!sm90::encode_bf16_map(&a.map_u, a.u, 3, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  if (a.tma_x) {  // x (B, H, W, C) as (C, W, H, B), boxes of 2 tw + 2 pixels of one row
    const cuuint64_t dims[4] = {(cuuint64_t)a.c, (cuuint64_t)a.w, (cuuint64_t)a.h,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {cb, cb * a.w, cb * a.w * a.h};
    const cuuint32_t box[4] = {kStepC, (cuuint32_t)(2 * a.tw + 2), 1, 1};
    if (!sm90::encode_bf16_map(&a.map_x, a.x, 4, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  void (*kernel)(Args) = &winograd_conv_cluster_wgmma_kernel<FT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(units * kCluster), 1, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC bf16; u (16, f, c) bf16; bias (f,) f32 or null;
// out (batch, h, w, f) bf16. All on the current device. Returns the CUDA
// error code of the launch (0 on success).
int nd_winograd_conv(const void* x, const void* u, const void* bias, void* out, int batch, int h,
                     int w, int c, int f, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || f <= 0 || (long long)16 * f * c > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Args a;
  std::memset(static_cast<void*>(&a), 0, sizeof(a));
  a.x = static_cast<const bf16*>(x);
  a.u = static_cast<const bf16*>(u);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.h = h, a.w = w, a.c = c, a.f = f;
  a.th = (h + 1) / 2, a.tw = (w + 1) / 2;
  a.steps = (c + kStepC - 1) / kStepC;
  const int ft = winograd_filter_tile(f);
  a.ftiles = (f + ft - 1) / ft;
  a.tiles = (long long)batch * a.th * a.tw;
  const long long units = (a.tiles + kTiles - 1) / kTiles * a.ftiles;
  if (units * kCluster > INT_MAX) return (int)cudaErrorInvalidValue;
  a.vec_x = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_u = c % 8 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  a.tma = a.vec_u;  // 16-byte global strides and base
  // the pixel rows by TMA where a box of a row's 2 tw + 2 pixels fits and a
  // unit's rows (two pixel rows a tile row) fit a raw slot
  a.box_tx = (2 * a.tw + 2) * kStepC * 2;
  a.box_bytes = (a.box_tx + 127) / 128 * 128;
  a.tma_x = a.vec_x && 2 * a.tw + 2 <= 256 && 2 * unit_rows(a.tw) * a.box_bytes <= kRawMax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ft == 64 ? launch_ft<64>(a, batch, units, s) : launch_ft<128>(a, batch, units, s));
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
