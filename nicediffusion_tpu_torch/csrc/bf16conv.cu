// The bf16 convolution of the sampling and serving forwards: bf16 x bf16 ->
// f32 sums on the tensor cores (wgmma), one launch a call, with a reduction
// order that no batch, row, batch mate, tiling or grid changes.
//
// Replaces no TPU kernel. The JAX package computes its convs and dense
// products in XLA (flax nn.Conv and nn.Dense with dtype=bf16,
// nicediffusion_tpu/models/unet.py:243-250, 357-420). The port ran them
// through cuDNN and cuBLAS, whose bf16 engines may split K across blocks
// (split-K, stream-K) by a plan that sees the whole batch: a row's sum then
// depends on where it sits, and the serving daemon's promise that a (seed,
// label) gives the same image in any batch and row broke in bf16
// (tools/find_batch_variance.py names the calls). Here every output element
// is summed by one thread's accumulator in one order, fixed per route:
//   halo route: 32-channel steps in order; inside a step the kernel rows
//     dy = 0, 1, 2; inside a row the columns dx = 0, 1, 2; inside a tap the
//     two k16 halves (one wgmma each);
//   row route: taps in order (dy, dx row-major); inside a tap the 32-channel
//     steps in order; inside a step the two k16 halves.
// wgmma sums its k16 products in a fixed order whatever its n (m64n64,
// m64n128 and m64n192 give the same bits), so the filter tile, the work
// unit and the grid are free: nothing splits K, and the plan
// (ops/kernels/conv.py::conv_nhwc_plan) reads the conv's map, k, stride and
// F, never the batch. A row's output is a function of that row alone, bit
// for bit, and equal to every earlier build's with these orders.
//
// For x (B, H, W, C) NHWC bf16, w (F, k, k, C) bf16 (channels innermost per
// filter and tap) and an optional bias (F,) bf16 it computes
//   acc = sum_{dy,dx,c} x[y s + dy - k/2, x s + dx - k/2, c] w[f, dy, dx, c]   f32
//   out = bf16(bf16(acc) + bias[f])
// with zero padding k / 2 and stride s of 1 or 2, k of 1 or 3: flax's
// rounding, the product rounded to bf16 and the bias added in bf16 (the two
// bf16 values summed in f32, exact, then one rounding). Without a bias,
// out = bf16(acc). A dense layer is a 1 x 1 conv over a (1, 1, M, C) view.
//
// What bounds it. Operations: 2 k^2 C F per output pixel against 2 (C + F)
// bytes, hundreds of operations a byte at the UNets' widths, above the
// card's ~295 for bf16 at 989 TFLOP/s and 3.35 TB/s: the tensor cores'
// rate. What kept the earlier build from it: the warps that multiplied also
// staged, in lockstep (a block barrier, the fragment loads and a drain of
// the tensor cores in every (step, kernel row) pair), and small maps (8 x 8,
// 16 x 16 at model batch 16) gave a few dozen blocks for 132 multiprocessors.
//
// The design: an implicit GEMM, M output pixels, N filters, K the k^2 taps x
// C channels, warp-specialised and persistent. A block is three warpgroups
// (384 threads): a producer that only loads (setmaxnreg gives its registers
// to the others) and two consumers that only issue wgmma, both operands read
// from shared memory by descriptor. The producer fills a ring of stages,
// each with a full and an empty mbarrier: a consumer waits on a stage's full
// barrier, issues its wgmma group, waits until one group is left in flight
// (wgmma_wait<1>) and then releases the previous stage on its empty barrier,
// so its next wait and the producer's loads overlap the products. (An
// earlier build of the halo route took A from registers, loaded by ldmatrix
// beside a group in flight; at one filter tile it gave other bits now and
// then: the compiler may hand a group's A registers on once it is issued.)
// A block walks the work units (two 64-pixel tiles, one a consumer, x 64 NB
// filters, NB = 1, 2 or 3; the filter tiles of one pixel tile consecutive)
// in a stride of the grid, one block a multiprocessor: the producer loads
// unit n + 1 while the consumers store unit n. The plan picks NB from the map so that small maps
// fill the card; the number of blocks is min(units, multiprocessors).
// Loads: by TMA (cp.async.bulk.tensor, one thread) where C is a multiple of
// 8 and x and the weights sit on 16 bytes: the weights through a 3-D tensor
// map over (F, k k, C), box (64 NB, 1, 32), the halo through a 4-D map over
// x, box (1, 10, 10, 32), the row route's A through a 2-D map over (M, C),
// box (128, 32); the boxes' out-of-bounds elements land as zeros (the
// padding, channels past C, filters past F, pixels past M). TMA's 64-byte
// swizzle is the layout the descriptors read: chunk c of row p at chunk
// c ^ ((p / 2) % 4). Elsewhere (C = 3, a view off 16 bytes, the row
// route's strided and 3 x 3 taps) the producer warpgroup's 128 threads stage
// the same bytes into the same places by cp.async (byte loads where no
// 16-byte copy is aligned) and arrive on the full barrier per thread.
//
// The halo route (bf16_conv_halo_wgmma_kernel): stride 1, k = 3. Each
// consumer owns an 8 x 8 tile of output pixels and its 10 x 10 halo; the
// tiles of all examples are numbered in one sequence, and a pixel's place
// in its tile depends on its coordinates alone. Tap (dy, dx) is the halo
// from pixel (dy, dx) on: a K-major A whose 8-row groups (the tile's rows)
// lie ten pixels apart, read by descriptor. A ring stage holds one kernel
// row's three taps' weight slabs (a pair); the halos of a step have a ring of
// two slots with barriers of their own, each released once the step's last
// group is done.
// The row route (bf16_conv_row_wgmma_kernel): k = 1, stride 2 and the dense
// view. M is linear, 128 output pixels a unit, all examples in one
// sequence. A ring stage holds the (tap, step) slab and the A tile (128
// pixels x 32 channels of the tap's shifted input), both read by descriptor.
// Epilogue (both): from the accumulators, the rounding above. Where F is a
// multiple of 8, into a staging tile in shared memory (64 filters x 64
// pixels a block, 128-byte swizzle) and out by one TMA store a block, which
// the consumer does not wait for: the next unit's products overlap it.
// Elsewhere the four lanes of a quad store eight consecutive filters of a
// pixel as pairs.

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
using namespace nd::conv;
using bf16 = __nv_bfloat16;

constexpr int kStepC = kRowBytes / 2;    // channels a step: one 64-byte row
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
constexpr int kEpc = 8;                  // bf16 elements a chunk
constexpr int kHalo = kHPx * kRowBytes;  // one tile's halo of a step: 6400 bytes
constexpr int kHaloPad = 13 * 512;       // its buffer, on whole 512-byte swizzle atoms
constexpr int kATile = kBM * kRowBytes;  // the row route's A of a step
constexpr int kOutBlock = 64 * 128;      // the epilogue's 64 rows x 64 filters
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kBlock = kConsumers + kWgThreads;  // two consumer warpgroups, one producer
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // 128 x 56 + 256 x 224 <= 65536

struct Args : Shape {
  CUtensorMap map_x;    // TMA: x (the halo route's 4-D map, the row route's 2-D one)
  CUtensorMap map_w;    // TMA: the weights, 3-D
  CUtensorMap map_out;  // TMA store: out (4-D on the halo route, 2-D on the row route)
  const bf16* x;
  const bf16* wt;
  const bf16* bias;  // null: no bias
  bf16* out;
  long long units;   // work units: (pixel tiles, filter tile)
  int ftiles;        // filter tiles of 64 NB
  int tma;           // 1: loads by TMA; 0: by cp.async
  int tma_out;       // 1: the epilogue through shared memory and a TMA store
};

template <int NB>
__device__ __forceinline__ void wgmma_ss(float (&d)[NB * 32], uint64_t a, uint64_t b) {
  if constexpr (NB == 1) sm90::wgmma_ss_m64n64k16_bf16(d, a, b, 1);
  if constexpr (NB == 2) sm90::wgmma_ss_m64n128k16_bf16(d, a, b, 1);
  if constexpr (NB == 3) sm90::wgmma_ss_m64n192k16_bf16(d, a, b, 1);
}

// The epilogue of a warpgroup's m64 x 64 NB tile. acc[32 cb + 4j + 2 half + e]
// is row 16 warp + lane / 4 + 8 half of the warpgroup, filter f0 + 64 cb + 8j
// + 2 (lane % 4) + e; pix[half] is that row's output pixel (its index over
// all examples), or -1 for a row that stores nothing.
template <int NB>
__device__ __forceinline__ void store_tile(const Args& a, const float (&acc)[NB * 32],
                                           const long long (&pix)[2], int f0, int lane) {
  const bool pairs = a.f % 2 == 0;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 64 * cb + 8 * j + 2 * (lane % 4);
      if (col >= a.f) continue;
      const bool two = col + 1 < a.f;
      const float b0 = a.bias != nullptr ? __bfloat162float(a.bias[col]) : 0.f;
      const float b1 = a.bias != nullptr && two ? __bfloat162float(a.bias[col + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (pix[half] < 0) continue;
        float v0 = acc[32 * cb + 4 * j + 2 * half], v1 = acc[32 * cb + 4 * j + 2 * half + 1];
        if (a.bias != nullptr) {
          v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), b0);
          v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), b1);
        }
        bf16* dst = a.out + (size_t)pix[half] * a.f + col;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// The epilogue by TMA store: store_tile's rounding into a warpgroup's staging
// buffer at buf, NB blocks of 64 filters, each 64 rows (the accumulator's)
// x 128 bytes in the 128-byte swizzle (chunk c of row r at c ^ (r % 8): a
// quad's 16 bytes land in another bank group in each of a warp's 8 rows)
template <int NB>
__device__ __forceinline__ void stage_out(const Args& a, const float (&acc)[NB * 32], uint32_t buf,
                                          int f0, int warp, int lane) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 64 * cb + 8 * j + 2 * (lane % 4);  // F % 8 = 0: col and col + 1
      const bool in = a.bias != nullptr && col < a.f;
      const float b0 = in ? __bfloat162float(a.bias[col]) : 0.f;
      const float b1 = in ? __bfloat162float(a.bias[col + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + lane / 4 + 8 * half;
        float v0 = acc[32 * cb + 4 * j + 2 * half], v1 = acc[32 * cb + 4 * j + 2 * half + 1];
        if (a.bias != nullptr) {
          v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), b0);
          v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), b1);
        }
        sm90::st_shared_b32(buf + (uint32_t)(cb * kOutBlock + row * 128 +
                                             ((j ^ (row & 7)) << 4) + 4 * (lane % 4)),
                            sm90::pack_bf16x2(v0, v1));
      }
    }
}

// A consumer warpgroup's epilogue by TMA store: wait until the buffer's
// previous stores have read it, stage the tile, then one thread stores each
// 64-filter block below F at the coordinates store(block, its address) names
template <int NB, typename Store>
__device__ __forceinline__ void store_out(const Args& a, const float (&acc)[NB * 32], uint32_t buf,
                                          int f0, int wg, int wtid, Store store) {
  if (wtid == 0) sm90::bulk_wait_read<0>();
  sm90::named_barrier(1 + wg, kWgThreads);
  stage_out<NB>(a, acc, buf, f0, wtid / 32, wtid % 32);
  sm90::fence_proxy_async();
  sm90::named_barrier(1 + wg, kWgThreads);
  if (wtid == 0) {
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
      if (f0 + 64 * cb < a.f) store(cb, buf + (uint32_t)(cb * kOutBlock));
    sm90::bulk_commit();
  }
}

// ------------------------------------------------- cp.async staging
// (the producer warpgroup's 128 threads, ptid 0 to 127, a chunk each in turn)

// the slabs of taps tap0 to tap0 + n - 1 at channel step `step`, filters f0
// to f0 + 64 NB - 1, into consecutive slabs of 64 NB rows at dst; filters
// past F and channels past C as zeros
template <int NB>
__device__ __forceinline__ void stage_slabs(uint32_t dst, const Args& a, int f0, int tap0, int n,
                                            int step, int ptid) {
  constexpr int kPer = 64 * NB * kChunks;  // chunks a slab
#pragma unroll 1
  for (int id = ptid; id < n * kPer; id += kWgThreads) {
    const int j = id / kPer, rem = id - j * kPer, r = rem / kChunks, q = rem % kChunks;
    const int fl = f0 + r, c = step * kStepC + q * kEpc;
    const int valid = fl < a.f ? min(max(a.c - c, 0), kEpc) : 0;
    const bf16* src = valid > 0 ? a.wt + ((size_t)fl * a.taps + tap0 + j) * a.c + c : a.wt;
    copy_chunk(dst + (uint32_t)(j * NB * kSlabBytes) + sm90::sw64_offset(r, q), src, 2 * valid,
               a.vec_w);
  }
}

// channel step `step` of the halos of tiles t0 and t1 into the halo slot at
// hb (t1's at hb + kHaloPad); zeros outside the map and past C
__device__ __forceinline__ void stage_halos(uint32_t hb, const Args& a, const Tile8& t0,
                                            const Tile8& t1, int step, int ptid) {
  constexpr int kPer = kHPx * kChunks;  // chunks a halo
#pragma unroll 1
  for (int id = ptid; id < 2 * kPer; id += kWgThreads) {
    const int i = id / kPer, rem = id - i * kPer, p = rem / kChunks, chunk = rem % kChunks;
    const int b = i ? t1.b : t0.b, y0 = i ? t1.y0 : t0.y0, x0 = i ? t1.x0 : t0.x0;
    const int yy = y0 + p / kHSide - 1, xx = x0 + p % kHSide - 1;
    const int ch = step * kStepC + chunk * kEpc;
    const bool inside = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const int valid = inside ? min(max(a.c - ch, 0), kEpc) : 0;
    const bf16* src =
        valid > 0 ? a.x + (((size_t)b * a.h + yy) * a.w + xx) * a.c + ch : a.x;
    copy_chunk(hb + (uint32_t)(i * kHaloPad) + sm90::sw64_offset(p, chunk), src, 2 * valid,
               a.vec_x);
  }
}

// a producer thread's arrival on a full barrier after its copies: once its
// cp.async land, or where some went by byte loads and shared stores, after
// its copies and a proxy fence (the wgmma operands are read through the
// async proxy)
__device__ __forceinline__ void arrive_copied(uint32_t bar, const Args& a) {
  if (a.vec_x && a.vec_w) {
    sm90::cp_async_mbar_arrive(bar);
  } else {
    sm90::cp_async_commit();
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bar);
  }
}

// ------------------------------------------------------------- halo route

template <int NB>
struct HaloRing {
  static constexpr int kStages = NB == 1 ? 8 : NB == 2 ? 6 : 4;
  static constexpr int kSlab = NB * kSlabBytes;  // 64 NB filters of one (tap, step)
  static constexpr int kStage = 3 * kSlab;       // the three taps of a kernel row
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOut = 2 * NB * kOutBlock;  // the two consumers' epilogue tiles
  static constexpr int kHalos = 2 * 2 * kHaloPad;  // two steps x two consumers
  static constexpr size_t kSmem = 1024 + kRing + kOut + kHalos + 8 * (2 * kStages + 4);
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

template <int NB>
__global__ void __launch_bounds__(kBlock, 1)
    bf16_conv_halo_wgmma_kernel(const __grid_constant__ Args a) {
  using R = HaloRing<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t outs = ring + R::kRing, halos = outs + R::kOut, full_w = halos + R::kHalos;
  const uint32_t empty_w = full_w + 8 * R::kStages, full_h = empty_w + 8 * R::kStages;
  const uint32_t empty_h = full_h + 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const uint32_t fills = a.tma ? 1u : (uint32_t)kWgThreads;  // arrivals a fill
    for (int i = 0; i < R::kStages; ++i) {
      sm90::mbar_init(full_w + 8u * i, fills);
      sm90::mbar_init(empty_w + 8u * i, 2);  // one a consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(full_h + 8u * i, fills);
      sm90::mbar_init(empty_h + 8u * i, 2);  // one a consumer warpgroup
    }
    sm90::fence_mbarrier_init();
  }
  __syncthreads();
  const int ftiles = a.ftiles, iters = 3 * a.steps;  // (step, kernel row) pairs, rows fastest

  if (tid >= kConsumers) {  // the producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumers;
    if (a.tma && ptid != 0) return;
    int ws = 0, wph = 0, hs = 0, hph = 0;
#pragma unroll 1
    for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {
      const int pair = (int)(u / ftiles), f0 = (int)(u - (long long)pair * ftiles) * 64 * NB;
      const Tile8 t0 = tile_of(2 * pair, a), t1 = tile_of(2 * pair + 1, a);
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        const int step = it / 3, dy = it - 3 * step;
        if (dy == 0) {  // the step's two halos into the next halo slot
          const uint32_t hb = halos + (uint32_t)(hs * 2 * kHaloPad), bar = full_h + 8u * hs;
          sm90::mbar_wait(empty_h + 8u * hs, hph ^ 1);
          if (a.tma) {
            sm90::mbar_arrive_expect_tx(bar, 2 * kHalo);
            sm90::tma_load_4d(hb, &a.map_x, bar, step * kStepC, t0.x0 - 1, t0.y0 - 1, t0.b);
            sm90::tma_load_4d(hb + kHaloPad, &a.map_x, bar, step * kStepC, t1.x0 - 1, t1.y0 - 1,
                              t1.b);
          } else {
            stage_halos(hb, a, t0, t1, step, ptid);
            arrive_copied(bar, a);
          }
          if (++hs == 2) hs = 0, hph ^= 1;
        }
        // the slabs of taps (dy, 0 to 2) into the next ring stage
        const uint32_t st = ring + (uint32_t)(ws * R::kStage), bar = full_w + 8u * ws;
        sm90::mbar_wait(empty_w + 8u * ws, wph ^ 1);
        if (a.tma) {
          sm90::mbar_arrive_expect_tx(bar, R::kStage);
          for (int dx = 0; dx < 3; ++dx)
            sm90::tma_load_3d(st + (uint32_t)(dx * R::kSlab), &a.map_w, bar, step * kStepC,
                              3 * dy + dx, f0);
        } else {
          stage_slabs<NB>(st, a, f0, 3 * dy, 3, step, ptid);
          arrive_copied(bar, a);
        }
        if (++ws == R::kStages) ws = 0, wph ^= 1;
      }
    }
    if (!a.tma) {
      sm90::cp_async_commit();
      sm90::cp_async_wait_all();
    }
  } else {  // the consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWgThreads, wtid = tid % kWgThreads, warp = wtid / 32, lane = tid % 32;
    int ws = 0, wph = 0, hs = 0, hph = 0;
    float acc[NB * 32];
#pragma unroll 1
    for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {
      const int pair = (int)(u / ftiles), f0 = (int)(u - (long long)pair * ftiles) * 64 * NB;
      const Tile8 t = tile_of(2 * pair + wg, a);
#pragma unroll
      for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
      int prev = -1, prev_h = -1;  // the stage and halo slot the group in flight reads
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        // wait for the pair's stage (at a step's first row also its halo) and
        // issue its six wgmma, A and B both by descriptor: tap (dy, dx) is
        // the halo from pixel (dy, dx) on, 8-row groups (tile rows) ten
        // pixels apart, so accumulator row g is tile pixel (g / 8, g % 8).
        // Once one group is left in flight, release what the previous pair
        // read: its stage, and at a step's last row its halo.
        const int step = it / 3, dy = it - 3 * step;
        if (dy == 0) sm90::mbar_wait(full_h + 8u * hs, hph);
        sm90::mbar_wait(full_w + 8u * ws, wph);
        if (!a.tma) sm90::fence_proxy_async();
        uint32_t hb =
            halos + (uint32_t)(hs * 2 * kHaloPad + wg * kHaloPad + dy * kHSide * kRowBytes);
        uint32_t st = ring + (uint32_t)(ws * R::kStage);
        asm volatile("" : "+r"(st), "+r"(hb));
        sm90::wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_ss<NB>(acc, sm90::sw64_desc(hb + dx * kRowBytes + kk * 32, kHSide * kRowBytes),
                         sm90::sw64_desc(st + dx * R::kSlab + kk * 32));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (prev >= 0 && wtid == 0) sm90::mbar_arrive(empty_w + 8u * prev);
        if (prev_h >= 0 && wtid == 0) sm90::mbar_arrive(empty_h + 8u * prev_h);
        prev = ws, prev_h = dy == 2 ? hs : -1;
        if (++ws == R::kStages) ws = 0, wph ^= 1;
        if (dy == 2 && ++hs == 2) hs = 0, hph ^= 1;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (wtid == 0) {
        sm90::mbar_arrive(empty_w + 8u * prev);
        sm90::mbar_arrive(empty_h + 8u * prev_h);
      }
      if (a.tma_out) {
        if (t.live)
          store_out<NB>(a, acc, outs + (uint32_t)(wg * NB * kOutBlock), f0, wg, wtid,
                        [&](int cb, uint32_t src) {
                          sm90::tma_store_4d(&a.map_out, src, f0 + 64 * cb, t.x0, t.y0, t.b);
                        });
      } else if (t.live) {
        long long pix[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int yy = t.y0 + 2 * warp + half, xx = t.x0 + lane / 4;
          pix[half] = yy < a.h && xx < a.w ? ((long long)t.b * a.h + yy) * a.w + xx : -1;
        }
        store_tile<NB>(a, acc, pix, f0, lane);
      }
    }
    if (a.tma_out && wtid == 0) sm90::bulk_wait<0>();
  }
}

// -------------------------------------------------------------- row route

template <int NB>
struct RowRing {
  static constexpr int kSlab = NB * kSlabBytes;
  static constexpr int kStage = kSlab + kATile;  // the slab, then A
  static constexpr int kStages = NB == 1 ? 16 : NB == 2 ? 11 : 8;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOut = 2 * NB * kOutBlock;  // the two consumers' epilogue tiles
  static constexpr size_t kSmem = 1024 + kRing + kOut + 8 * 2 * kStages;
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

template <int NB>
__global__ void __launch_bounds__(kBlock, 1)
    bf16_conv_row_wgmma_kernel(const __grid_constant__ Args a) {
  using R = RowRing<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t outs = ring + R::kRing, full = outs + R::kOut, empty = full + 8 * R::kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      sm90::mbar_init(full + 8u * i, a.tma ? 1u : (uint32_t)kWgThreads);
      sm90::mbar_init(empty + 8u * i, 2);
    }
    sm90::fence_mbarrier_init();
  }
  __syncthreads();
  const int ftiles = a.ftiles, iters = a.taps * a.steps;  // (tap, step) pairs, steps fastest

  if (tid >= kConsumers) {  // the producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumers;
    if (a.tma && ptid != 0) return;
    int ws = 0, wph = 0;
#pragma unroll 1
    for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {
      const long long mt = u / ftiles, m0 = mt * kBM;
      const int f0 = (int)(u - mt * ftiles) * 64 * NB;
      // cp.async: this thread's A row, output pixel m0 + ptid
      const long long m = m0 + ptid;
      const bool live = m < a.m;
      int img, iy, ix;
      {
        const long long per_img = (long long)a.ho * a.wo, mm = live ? m : 0;
        const long long b = mm / per_img;
        const int rem = (int)(mm - b * per_img), oy = rem / a.wo, ox = rem - oy * a.wo;
        img = (int)b;
        iy = oy * a.stride - a.pad;
        ix = ox * a.stride - a.pad;
      }
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        const int tap = it / a.steps, step = it - tap * a.steps;
        const uint32_t st = ring + (uint32_t)(ws * R::kStage), bar = full + 8u * ws;
        sm90::mbar_wait(empty + 8u * ws, wph ^ 1);
        if (a.tma) {  // k = 1, stride 1: A is rows m0 to m0 + 127 of x as (M, C)
          sm90::mbar_arrive_expect_tx(bar, R::kStage);
          sm90::tma_load_3d(st, &a.map_w, bar, step * kStepC, tap, f0);
          sm90::tma_load_2d(st + R::kSlab, &a.map_x, bar, step * kStepC, (int)m0);
        } else {
          stage_slabs<NB>(st, a, f0, tap, 1, step, ptid);
          const int dy = tap / a.k, dx = tap - dy * a.k, yy = iy + dy, xx = ix + dx;
          const bool in = live && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
          const bf16* src = a.x + (in ? (((size_t)img * a.h + yy) * a.w + xx) * a.c : 0);
#pragma unroll
          for (int chunk = 0; chunk < kChunks; ++chunk) {
            const int c = step * kStepC + chunk * kEpc;
            const int valid = in ? min(max(a.c - c, 0), kEpc) : 0;
            copy_chunk(st + R::kSlab + sm90::sw64_offset(ptid, chunk),
                       valid > 0 ? src + c : a.x, 2 * valid, a.vec_x);
          }
          arrive_copied(bar, a);
        }
        if (++ws == R::kStages) ws = 0, wph ^= 1;
      }
    }
    if (!a.tma) {
      sm90::cp_async_commit();
      sm90::cp_async_wait_all();
    }
  } else {  // the consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid / kWgThreads, wtid = tid % kWgThreads, warp = wtid / 32, lane = tid % 32;
    int ws = 0, wph = 0, prev = -1;
    float acc[NB * 32];
#pragma unroll 1
    for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {
      const long long mt = u / ftiles, m0 = mt * kBM;
      const int f0 = (int)(u - mt * ftiles) * 64 * NB;
#pragma unroll
      for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        sm90::mbar_wait(full + 8u * ws, wph);
        if (!a.tma) sm90::fence_proxy_async();
        uint32_t st = ring + (uint32_t)(ws * R::kStage);
        uint32_t at = st + (uint32_t)(R::kSlab + wg * 64 * kRowBytes);
        asm volatile("" : "+r"(st), "+r"(at));
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss<NB>(acc, sm90::sw64_desc(at + kk * 32), sm90::sw64_desc(st + kk * 32));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (prev >= 0 && wtid == 0) sm90::mbar_arrive(empty + 8u * prev);
        prev = ws;
        if (++ws == R::kStages) ws = 0, wph ^= 1;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (wtid == 0) sm90::mbar_arrive(empty + 8u * prev);
      prev = -1;
      const long long mw = m0 + 64 * wg;  // this warpgroup's first output pixel
      if (a.tma_out) {
        if (mw < a.m)
          store_out<NB>(a, acc, outs + (uint32_t)(wg * NB * kOutBlock), f0, wg, wtid,
                        [&](int cb, uint32_t src) {
                          sm90::tma_store_2d(&a.map_out, src, f0 + 64 * cb, (int)mw);
                        });
        continue;
      }
      long long pix[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long mo = mw + 16 * warp + lane / 4 + 8 * half;
        pix[half] = mo < a.m ? mo : -1;
      }
      store_tile<NB>(a, acc, pix, f0, lane);
    }
    if (a.tma_out && wtid == 0) sm90::bulk_wait<0>();
  }
}

// ---------------------------------------------------------------- launch

// multiprocessors of the current device, read once per device
int multiprocessors() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

template <int NB>
cudaError_t launch_nb(Args& a, int batch, int route, int max_blocks, cudaStream_t stream) {
  const bool halo = route == 1;
  void (*kernel)(Args) = halo ? &bf16_conv_halo_wgmma_kernel<NB> : &bf16_conv_row_wgmma_kernel<NB>;
  const size_t smem = halo ? HaloRing<NB>::kSmem : RowRing<NB>::kSmem;
  a.ftiles = (a.f + 64 * NB - 1) / (64 * NB);
  a.units = (halo ? ((long long)a.tiles + 1) / 2 : (a.m + kBM - 1) / kBM) * a.ftiles;
  if (a.tma) {
    const cuuint64_t cb = 2ull * a.c;  // bytes a pixel or a (filter, tap)
    const cuuint64_t wdims[3] = {(cuuint64_t)a.c, (cuuint64_t)a.taps, (cuuint64_t)a.f};
    const cuuint64_t wstrides[2] = {cb, cb * a.taps};
    const cuuint32_t wbox[3] = {kStepC, 1, 64 * NB};
    bool ok = sm90::encode_bf16_map(&a.map_w, a.wt, 3, wdims, wstrides, wbox);
    if (halo) {
      const cuuint64_t xdims[4] = {(cuuint64_t)a.c, (cuuint64_t)a.w, (cuuint64_t)a.h,
                                   (cuuint64_t)batch};
      const cuuint64_t xstrides[3] = {cb, cb * a.w, cb * a.w * a.h};
      const cuuint32_t xbox[4] = {kStepC, kHSide, kHSide, 1};
      ok = ok && sm90::encode_bf16_map(&a.map_x, a.x, 4, xdims, xstrides, xbox);
    } else {
      const cuuint64_t xdims[2] = {(cuuint64_t)a.c, (cuuint64_t)a.m};
      const cuuint64_t xstrides[1] = {cb};
      const cuuint32_t xbox[2] = {kStepC, kBM};
      ok = ok && sm90::encode_bf16_map(&a.map_x, a.x, 2, xdims, xstrides, xbox);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  if (a.tma_out) {  // out (batch, ho, wo, f) in boxes of 64 filters x 64 pixels
    const cuuint64_t fb = 2ull * a.f;
    bool ok;
    if (halo) {
      const cuuint64_t dims[4] = {(cuuint64_t)a.f, (cuuint64_t)a.wo, (cuuint64_t)a.ho,
                                  (cuuint64_t)batch};
      const cuuint64_t strides[3] = {fb, fb * a.wo, fb * a.wo * a.ho};
      const cuuint32_t box[4] = {64, kSide, kSide, 1};
      ok = sm90::encode_bf16_map(&a.map_out, a.out, 4, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      const cuuint64_t dims[2] = {(cuuint64_t)a.f, (cuuint64_t)a.m};
      const cuuint64_t strides[1] = {fb};
      const cuuint32_t box[2] = {64, 64};
      ok = sm90::encode_bf16_map(&a.map_out, a.out, 2, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  long long blocks = a.units < multiprocessors() ? a.units : multiprocessors();
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (batch, h, w, c) NHWC bf16; wt (f, k, k, c) bf16; bias (f,) bf16 or null;
// out (batch, ho, wo, f) bf16, ho = (h - 1) / stride + 1, the same for wo
// (padding k / 2). route 0 is the row route, 1 the halo route (k = 3,
// stride 1); filter_tile 64, 128 or 192. max_blocks > 0 caps the persistent
// grid (else one block a multiprocessor, at most one a work unit); staging 0
// loads and stores by TMA where the call allows it, bit 0 set loads by
// cp.async always, bit 1 set stores from registers always (every way gives
// the same bits). All on the current device. Returns the CUDA error code of
// the launch (0 on success).
int nd_bf16_conv(const void* x, const void* wt, const void* bias, void* out, int batch, int h,
                 int w, int c, int f, int k, int stride, int route, int filter_tile,
                 int max_blocks, int staging, void* stream) {
  Args a;
  std::memset(static_cast<void*>(&a), 0, sizeof(a));
  if (!make_shape(a, batch, h, w, c, f, k, stride, route, filter_tile, x, 2, wt, 2))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.wt = static_cast<const bf16*>(wt);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  // TMA: 16-byte global strides and bases, int coordinates, and on the row
  // route an A that is x itself (k = 1, stride 1)
  a.tma = (staging & 1) == 0 && c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(wt) % 16 == 0 && a.m <= INT_MAX &&
          (route == 1 || (k == 1 && stride == 1));
  // the TMA store: 16-byte rows of out (F % 8 = 0) on 16 bytes, int coordinates
  a.tma_out = (staging & 2) == 0 && f % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
              a.m <= INT_MAX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (filter_tile / 64) {
    case 1: return (int)launch_nb<1>(a, batch, route, max_blocks, s);
    case 2: return (int)launch_nb<2>(a, batch, route, max_blocks, s);
    default: return (int)launch_nb<3>(a, batch, route, max_blocks, s);
  }
}

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
