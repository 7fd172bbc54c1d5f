// Spread (type-1 step 1) for NVIDIA Hopper: slot-order point values ->
// per-tile halo-padded blocks [num_tiles, B2, *ext] (float32, rank 2 or
// 3).
//
// Replaces nine Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_mats
//   and :_spread_kernel_mats (the rank-3 per-tile grid): precomputed
//     kernel weights; here spread_kernel<kPlanned = true>;
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident
//   and :_spread_kernel (the rank-3 per-tile grid with its sub-chunk
//     fold): Horner or exp/sqrt evaluated in-kernel on the two-float
//     coordinates; here spread_kernel<kPlanned = false>;
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_split
//   and :_spread_kernel_split: the same with separate coords and values
//     payloads, which the TPU takes for channel groups wider than one
//     8-row combined payload (2 * rank + B2 > 8: the source and points
//     gradients of training) and for slot-order values (values_slots:
//     PlannedNufft.normal, apply_from_slots); here
//     spread_kernel<kPlanned = false> at any B2, the channel groups on
//     blockIdx.y, the last one partial. Values are always read in slot
//     order, so slot-order input only skips the caller's gather.
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_banded
//   and :_spread_kernel_split_banded (the planned rank-3 binned level:
//     z-ordered binning on a coarse axis-0 geometry, sub-chunk j touching
//     only the axis-0 rows [zorigins[j], + band)); here
//     spread_banded_kernel<kFused = false>, which reads coords and values
//     separately at any B2 (the combined/split split is a TPU DMA
//     detail);
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_split_banded_dfta
//     (the same with the axis-2 mode-DFT pass as an epilogue); here
//     spread_banded_kernel<kFused = true>.
// The TPU needs the per-tile-grid and split twins because VMEM cannot
// hold the whole tile array and a DMA moves 8-row blocks; on Hopper
// every unbanded block owns one tile at any rank and reads coords and
// values separately, so one kernel serves the six unbanded TPU kernels.
//
// Design (unbanded). One thread block per (tile, channel group) owns the
// tile's [group, *ext] halo block in dynamic shared memory (20.7 KB per
// channel at 2D ext 72^2, 166 KB at 3D ext (24, 24, 72)) and walks the
// tile's own chunks tile_bounds[t] .. tile_bounds[t+1]; the TPU kernels
// walked one global chunk stream (or one grid step per tile in
// sequence), which has no counterpart when blocks run in parallel. Each
// chunk is staged in kSub-slot pieces: per slot the kRank axis windows
// (start + width weights, loaded from the planned artifact or evaluated
// here) and the group's values. Then every thread owns one row of the
// block along the last axis -- (channel, e0) at rank 2, (channel, e0,
// e1) at rank 3 -- and adds, in slot order, the contribution wl * (v *
// wlast[j]) of each slot whose leading-axis windows cover its row, where
// wl is the product of the leading-axis weights (w0 at rank 2, w0 * w1
// at rank 3: the Khatri-Rao factor of the TPU kernels' fold).
//
// Design (banded). At the binned level's coarse geometry one tile block
// is [136, 24, 72] per channel at the 3D headline (939 KB): four times
// the 227 KB a block may hold, so no block can own a whole tile. Two
// kernels run per call. banded_windows_kernel evaluates every slot's
// three axis windows once, one thread per slot, into a scratch [3][slots]
// of starts and [3][slots][w] of weights: es_window_exact forms the
// kernel argument from the fine-grid row, which does not round where the
// TPU kernel's (hi - origin) - zo does, and axis 0 counts from the slot's
// band origin. Then spread_banded_kernel gives a block one axis-0 slab of
// a tile's rows for a channel group of one or two (kSlab rows; 7 at the
// headline, 109 KB, two blocks per SM) and each warp one row of it: the
// warp owns that row's E1 x E2 plane in every channel of the group, and
// walks, with no block barrier, the tile's sub-chunks whose band
// [zorigins[j], + band) holds the row. It tests 32 slots at a time
// against the row (one ballot); the hitting lanes load their slot's
// axis-0 weight, starts and values into registers and copy its axis-1 and
// axis-2 windows into the warp's shared copy, and the warp takes the hits
// in slot order: shuffled to all lanes, each hit's w x w (e1, e2) window
// goes across the lanes, lane l taking window offsets t = l + 32 q (d1 =
// t / w, d2 = t % w), one product per cell and channel. The lanes form
// the products of a few hits first, then add them hit by hit, a warp
// barrier after each hit ordering one cell's additions across lanes.
// Within a round the lanes touch w^2 cells of at most five rows of the
// plane, a stride of 8 banks per row: at most a 2-way bank conflict. The
// fused variant gives each block (t0, t1, slab, pair) all nt2 tiles of
// its (t0, t1) in turn: it spreads tile t2's slab, then contracts its E2
// axis with t2's wrap-aware, deconvolving twiddles (c, s - c, s + c: the
// Gauss three-multiply rotation of pallas_dft._pass_a_kernel) into
// y [nt0, nt1, B2, E0, E1, n2], written at t2 = 0 and added to after, so
// the t2 sum is a loop inside the block (no carry between blocks, no
// atomics).
//
// Determinism: each output cell is written by one thread (banded: one
// warp, whose barrier orders its lanes), in slot order (and t2 order),
// with no atomics, so every result is bit-repeatable like the TPU
// kernel's. Shared-memory atomics (the cuFINUFFT SM method) would let all
// threads work on every slot, at the cost of that repeatability. Each
// banded cell gets (w0 w1) (v w2) with the products rounded as written
// (__fmul_rn, __fadd_rn), the rounding of the row-owner kernel this
// design replaced, and the same slot order, so the two agree bit for bit.
//
// What bounds it on the H100: the kernels are latency- and
// occupancy-bound, not bound by memory traffic (each input is read about
// once). Unbanded, each thread owns a row along the last axis and tests
// every staged slot: at the 2D headline (8 x 8 tiles) the grid has 64
// blocks for 132 SMs, and only the rows a slot's window covers do work on
// it (w of E0 rows at rank 2, w^2 = 49 of the 576 rows at 3D ext (24, 24,
// 72)); at rank 3 a block of 166 KB allows one block per SM. The banded
// kernel's row-owner predecessor did 1.2e9 such tests and serial
// read-modify-writes for 5.5e8 useful multiply-adds at the 3D headline
// (5.9 ms against a 0.08 ms byte bound on an H100). The warp-per-row
// design does one ballot per 32 slots and row and puts a hit's w^2 cells
// on the lanes in parallel; what bounds it now is the chain of each hit,
// about 17 shared-memory or shuffle operations for a channel pair, taken
// in order by one warp, with only 14 to 16 warps per SM (a row's planes
// fill the shared memory): about 700 SM cycles per hit and warp at the
// headline, the same from 3 to 16 rows a block (PERF.md).
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;

constexpr int kSub = 128;  // slots staged at a time (kernels/spread.py)
constexpr int kStrip = 8;  // rows per thread in the fused epilogue
// Threads of a banded spread block at most (kernels/spread.py): 16 warps,
// one per slab row, so that 128 registers a thread fit.
constexpr int kMaxBandedThreads = 512;

template <int kRank, bool kPlanned>
__global__ void spread_kernel(const int* __restrict__ tile_bounds,
                              const float* __restrict__ values,
                              const float* __restrict__ coords,
                              const float* __restrict__ weights,
                              const int* __restrict__ starts,
                              float* __restrict__ out, Geometry g,
                              EsKernel k) {
  constexpr int kLast = kRank - 1;
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int w = k.width;
  const int len = g.e[kLast];  // row length: the last axis
  int rows = 1;                // rows per channel: the leading axes
#pragma unroll
  for (int d = 0; d < kLast; ++d) rows *= g.e[d];
  const int cells = rows * len;
  float* acc = smem;                            // [group][*ext]
  float* sw = acc + g.group * cells;            // [kRank][kSub][w]
  float* sv = sw + kRank * kSub * w;            // [group][kSub] values
  int* ss = reinterpret_cast<int*>(sv + g.group * kSub);  // [kRank][kSub]

  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) acc[i] = 0.0f;
  float origin[kRank];
  tnt::tile_origins<kRank>(g, tile, origin);
  const int kbeg = tile_bounds[tile];
  const int kend = tile_bounds[tile + 1];
  // The row this thread owns: channel b and its leading-axis indices.
  const int row = threadIdx.x;
  const bool owner = row < nc * rows;
  const int b = row / rows;
  int lead[kRank];
  int r = row - b * rows;
#pragma unroll
  for (int d = kLast - 1; d >= 0; --d) {
    lead[d] = r % g.e[d];
    r /= g.e[d];
  }
  float* arow = acc + row * len;

  for (int kc = kbeg; kc < kend; ++kc) {
    for (int off = 0; off < g.chunk; off += kSub) {
      const int n = min(kSub, g.chunk - off);
      const int base = kc * g.chunk + off;
      __syncthreads();  // the previous piece is consumed
      if (kPlanned) {
        for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
#pragma unroll
          for (int d = 0; d < kRank; ++d)
            sw[d * kSub * w + i] =
                weights[((size_t)d * g.slots + base) * w + i];
        }
      }
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int slot = base + i;
#pragma unroll
        for (int d = 0; d < kRank; ++d) {
          if (kPlanned) {
            ss[d * kSub + i] = starts[(size_t)d * g.slots + slot];
          } else {
            ss[d * kSub + i] = tnt::es_window(
                coords[(size_t)d * g.slots + slot],
                coords[(size_t)(kRank + d) * g.slots + slot], origin[d], k,
                sw + (d * kSub + i) * w);
          }
        }
        for (int c = 0; c < nc; ++c)
          sv[c * kSub + i] = values[(size_t)(c0 + c) * g.slots + slot];
      }
      __syncthreads();
      if (owner) {
        for (int i = 0; i < n; ++i) {
          bool covered = true;
          float wl = 1.0f;
#pragma unroll
          for (int d = 0; d < kLast; ++d) {
            const int dd = lead[d] - ss[d * kSub + i];
            if ((unsigned)dd >= (unsigned)w) {
              covered = false;
              break;
            }
            const float wd = sw[(d * kSub + i) * w + dd];
            wl = d == 0 ? wd : __fmul_rn(wl, wd);
          }
          if (!covered) continue;
          const float v = sv[b * kSub + i];
          const int s = ss[kLast * kSub + i];
          const float* wlast = sw + (kLast * kSub + i) * w;
          for (int j = 0; j < w; ++j) {
            const int col = s + j;
            if ((unsigned)col < (unsigned)len)
              arow[col] = __fadd_rn(arow[col],
                                    __fmul_rn(wl, __fmul_rn(v, wlast[j])));
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = out + ((size_t)tile * g.batch2 + c0) * cells;
  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) dst[i] = acc[i];
}

// The widest kernel that kRounds lane rounds (w^2 <= 32 kRounds) serve.
template <int kRounds>
__host__ __device__ constexpr int rounds_width() {
  return kRounds == 1 ? 5 : kRounds == 2 ? 8 : kRounds == 4 ? 11 : 16;
}

// The banded spread's windows, one thread per slot of the chunks the
// tiles own: st [3][slots] the window starts (axis 0 from the slot's band
// origin) and ws [3][slots][w] the weights, from es_window_exact.
template <int kW>
__global__ void banded_windows_kernel(const int* __restrict__ tile_bounds,
                                      const int* __restrict__ zorigins,
                                      const float* __restrict__ coords,
                                      float* __restrict__ ws,
                                      int* __restrict__ st, Geometry g,
                                      EsKernel k, tnt::Band bd) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = tnt::num_tiles(g);
  if (slot >= g.slots) return;
  const int kc = slot / g.chunk;
  if (kc >= tile_bounds[nt]) return;  // a chunk no tile owns
  int lo = 0, hi = nt - 1;            // the tile owning chunk kc
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_bounds[mid] <= kc) lo = mid; else hi = mid - 1;
  }
  float origin[3];
  tnt::tile_origins<3>(g, lo, origin);
  origin[0] = __fadd_rn(origin[0], (float)zorigins[slot / bd.sublen]);
  float w[kW];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    st[(size_t)d * g.slots + slot] = tnt::es_window_exact<kW>(
        coords[(size_t)d * g.slots + slot],
        coords[(size_t)(3 + d) * g.slots + slot], origin[d], k, w);
    float* dst = ws + ((size_t)d * g.slots + slot) * k.width;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (j < k.width) dst[j] = w[j];
  }
}

// Adds tile `tile`'s slots into the slab block acc[group][slab][E1][E2]
// of axis-0 rows [r0, r0 + nrows), channels c0 .. c0 + nc (nc <= 2):
// warp r owns row r0 + r of every channel. It walks the tile's
// sub-chunks whose band holds its row, in slot order, tests 32 slots at a
// time against the row (one ballot) and takes the hits in order: lane l
// covers window offsets t = l + 32 q (d1 = t / w, d2 = t % w) of the
// hit's (e1, e2) window in every channel, and a warp barrier after each
// hit orders one cell's additions across lanes. The warps run without a
// block barrier.
template <int kRounds>
__device__ void banded_accumulate(int tile, int r0, int nrows, int c0,
                                  int nc, const int* __restrict__ tile_bounds,
                                  const int* __restrict__ zorigins,
                                  const float* __restrict__ values,
                                  const float* __restrict__ ws,
                                  const int* __restrict__ st,
                                  float* __restrict__ acc,
                                  float* __restrict__ wwin, const Geometry& g,
                                  const EsKernel& k, const tnt::Band& bd) {
  // Hits whose products a lane forms before it adds them, in order.
  constexpr int kStep = kRounds >= 8 ? 1 : 8 / kRounds;
  const int w = k.width;
  const int e1 = g.e[1], e2 = g.e[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= nrows) return;
  const int a0 = r0 + warp;  // the extended-tile row
  const size_t slots = g.slots;
  float* plane0 = acc + (size_t)warp * e1 * e2;
  float* plane1 = plane0 + (size_t)bd.slab * e1 * e2;  // channel c0 + 1
  // This warp's copy of the axis-1 and axis-2 windows of its 32 slots:
  // [32][2][w], lane l's slot first.
  float* mywin = wwin + (size_t)warp * 64 * w;
  const float* v0 = values + (size_t)c0 * slots;
  const float* v1 = v0 + slots;
  int d1[kRounds], d2[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int t = lane + 32 * q;
    d1[q] = t < w * w ? t / w : -1;
    d2[q] = t - (t / w) * w;
  }
  const int subs = g.chunk / bd.sublen;
  const int sbeg = tile_bounds[tile] * subs;
  const int send = tile_bounds[tile + 1] * subs;
  for (int sc0 = sbeg; sc0 < send; sc0 += 32) {
    const int sc = sc0 + lane;
    const int zo = sc < send ? zorigins[sc] : 0;
    unsigned held = __ballot_sync(
        0xffffffffu, sc < send && (unsigned)(a0 - zo) < (unsigned)bd.band);
    while (held) {
      const int src = __ffs(held) - 1;
      held &= held - 1u;
      const int q0 = a0 - __shfl_sync(0xffffffffu, zo, src);  // band row
      const int beg = (sc0 + src) * bd.sublen, end = beg + bd.sublen;
      for (int base = beg; base < end; base += 32) {
        // Each lane loads the parameters of its own slot, if it hits the
        // row, and the hits go out to the warp by shuffles.
        const int i = base + lane;
        const int d0 = i < end ? q0 - st[i] : -1;
        const bool hit = (unsigned)d0 < (unsigned)w;
        unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m == 0u) continue;
        float mw0 = 0.0f, mv0 = 0.0f, mv1 = 0.0f;
        int ms1 = 0, ms2 = 0;
        __syncwarp();  // the previous group's windows are consumed
        if (hit) {
          mw0 = ws[(size_t)i * w + d0];
          ms1 = st[slots + i];
          ms2 = st[2 * slots + i];
          mv0 = v0[i];
          mv1 = nc > 1 ? v1[i] : 0.0f;
          const float* src1 = ws + (slots + i) * w;
          const float* src2 = ws + (2 * slots + i) * w;
          float* dst = mywin + lane * 2 * w;
          for (int j = 0; j < w; ++j) {
            dst[j] = src1[j];
            dst[w + j] = src2[j];
          }
        }
        __syncwarp();
        while (m) {
          // kStep hits at a time: first every product and cell (reads of
          // the windows only), then the adds, hit by hit in slot order.
          float val0[kStep][kRounds], val1[kStep][kRounds];
          int at[kStep][kRounds];
#pragma unroll
          for (int h = 0; h < kStep; ++h) {
            const bool any = m != 0u;  // uniform
            const int src2 = any ? __ffs(m) - 1 : 0;
            if (any) m &= m - 1u;
            const float w0 = __shfl_sync(0xffffffffu, mw0, src2);
            const float x0 = __shfl_sync(0xffffffffu, mv0, src2);
            const float x1 = __shfl_sync(0xffffffffu, mv1, src2);
            const int s1 = __shfl_sync(0xffffffffu, ms1, src2);
            const int s2 = __shfl_sync(0xffffffffu, ms2, src2);
            const float* w1 = mywin + src2 * 2 * w;
            const float* w2 = w1 + w;
#pragma unroll
            for (int q = 0; q < kRounds; ++q) {
              const int c1 = s1 + d1[q], c2 = s2 + d2[q];
              const bool ok = any && d1[q] >= 0 &&
                              (unsigned)c1 < (unsigned)e1 &&
                              (unsigned)c2 < (unsigned)e2;
              at[h][q] = ok ? c1 * e2 + c2 : -1;
              const float wl = ok ? __fmul_rn(w0, w1[d1[q]]) : 0.0f;
              const float wz = ok ? w2[d2[q]] : 0.0f;
              val0[h][q] = __fmul_rn(wl, __fmul_rn(x0, wz));
              val1[h][q] = __fmul_rn(wl, __fmul_rn(x1, wz));
            }
          }
#pragma unroll
          for (int h = 0; h < kStep; ++h) {
            // One hit's cells are distinct: its reads go first.
            float old0[kRounds], old1[kRounds];
#pragma unroll
            for (int q = 0; q < kRounds; ++q) {
              const int a = max(at[h][q], 0);
              old0[q] = plane0[a];
              if (nc > 1) old1[q] = plane1[a];
            }
#pragma unroll
            for (int q = 0; q < kRounds; ++q) {
              if (at[h][q] < 0) continue;
              plane0[at[h][q]] = __fadd_rn(old0[q], val0[h][q]);
              if (nc > 1) plane1[at[h][q]] = __fadd_rn(old1[q], val1[h][q]);
            }
            __syncwarp();
          }
        }
      }
    }
  }
}

// Rank-3 banded spread: one warp per slab row (of every channel of the
// group), 32 * slab threads; ws/st the windows of banded_windows_kernel.
// Block (tile * nslabs + slab, channel group) -> out[tile][c0..][slab
// rows] (kFused = false); block (t01 * nslabs + slab, channel pair) ->
// y[t0][t1][c0, c0 + 1][slab rows][E1][n2], the slab spread for each t2
// in turn and contracted with that tile's twiddles tw [3][nt2][E2][n2]
// (kFused = true).
template <bool kFused, int kRounds>
__global__ void __launch_bounds__(kMaxBandedThreads)
    spread_banded_kernel(const int* __restrict__ tile_bounds,
                         const int* __restrict__ zorigins,
                         const float* __restrict__ values,
                         const float* __restrict__ ws,
                         const int* __restrict__ st,
                         const float* __restrict__ tw,
                         float* __restrict__ out, Geometry g, EsKernel k,
                         tnt::Band bd) {
  // acc [group][slab][E1][E2], then each warp's windows [32][2][w].
  extern __shared__ float acc[];
  const int e0 = g.e[0], e1 = g.e[1], e2 = g.e[2];
  const int nslabs = (e0 + bd.slab - 1) / bd.slab;
  const int slab = blockIdx.x % nslabs;
  const int r0 = slab * bd.slab;
  const int nrows = min(bd.slab, e0 - r0);
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int cells = nrows * e1 * e2;     // per channel
  const int stride = bd.slab * e1 * e2;  // channel stride of acc
  float* wwin = acc + g.group * stride;
  if (!kFused) {
    const int tile = blockIdx.x / nslabs;
    for (int c = 0; c < nc; ++c)
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        acc[c * stride + i] = 0.0f;
    __syncthreads();
    banded_accumulate<kRounds>(tile, r0, nrows, c0, nc, tile_bounds,
                               zorigins, values, ws, st, acc, wwin, g, k,
                               bd);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      float* dst = out + (((size_t)tile * g.batch2 + c0 + c) * e0 + r0) *
                             e1 * e2;
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        dst[i] = acc[c * stride + i];
    }
    return;
  }
  const int t01 = blockIdx.x / nslabs;
  const int nt2 = g.nt[2], n2 = bd.n2;
  const size_t plane = (size_t)e1 * n2;
  float* yr = out + (((size_t)t01 * g.batch2 + c0) * e0 + r0) * plane;
  float* yi = yr + (size_t)e0 * plane;
  for (int t2 = 0; t2 < nt2; ++t2) {
    for (int c = 0; c < 2; ++c)
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        acc[c * stride + i] = 0.0f;
    __syncthreads();
    banded_accumulate<kRounds>(t01 * nt2 + t2, r0, nrows, c0, 2,
                               tile_bounds, zorigins, values, ws, st, acc,
                               wwin, g, k, bd);
    __syncthreads();
    const float* cw = tw + (size_t)t2 * e2 * n2;
    const float* smcw = cw + (size_t)nt2 * e2 * n2;
    const float* spcw = smcw + (size_t)nt2 * e2 * n2;
    // A thread takes mode m of kStrip rows: each twiddle triple it loads
    // serves the strip, and a warp's threads (consecutive m) read each
    // slab value once, broadcast.
    const int rows = nrows * e1;
    const int strips = (rows + kStrip - 1) / kStrip;
    for (int o = threadIdx.x; o < strips * n2; o += blockDim.x) {
      const int m = o % n2;
      const int r0 = (o / n2) * kStrip;
      const int nr = min(kStrip, rows - r0);
      float t1[kStrip], t2s[kStrip], t3[kStrip];
#pragma unroll
      for (int r = 0; r < kStrip; ++r) t1[r] = t2s[r] = t3[r] = 0.0f;
      for (int e = 0; e < e2; ++e) {
        const size_t at = (size_t)e * n2 + m;
        const float c = cw[at], smc = smcw[at], spc = spcw[at];
#pragma unroll
        for (int r = 0; r < kStrip; ++r) {
          if (r < nr) {
            const float a = acc[(r0 + r) * e2 + e];
            const float bi = acc[stride + (r0 + r) * e2 + e];
            t1[r] += (a + bi) * c;
            t2s[r] += a * smc;
            t3[r] += bi * spc;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        if (r < nr) {
          const size_t at = (size_t)(r0 + r) * n2 + m;
          const float vr = t1[r] - t3[r], vi = t1[r] + t2s[r];
          yr[at] = t2 == 0 ? vr : yr[at] + vr;
          yi[at] = t2 == 0 ? vi : yi[at] + vi;
        }
      }
    }
    __syncthreads();  // acc is zeroed again for the next t2
  }
}

using BandedFn = void (*)(const int*, const int*, const float*,
                          const float*, const int*, const float*, float*,
                          Geometry, EsKernel, tnt::Band);
using WindowsFn = void (*)(const int*, const int*, const float*, float*,
                           int*, Geometry, EsKernel, tnt::Band);

template <bool kFused>
BandedFn banded_rounds(int width) {
  if (width <= rounds_width<1>()) return spread_banded_kernel<kFused, 1>;
  if (width <= rounds_width<2>()) return spread_banded_kernel<kFused, 2>;
  if (width <= rounds_width<4>()) return spread_banded_kernel<kFused, 4>;
  return spread_banded_kernel<kFused, 8>;
}

BandedFn banded_fn(bool fused, int width) {
  return fused ? banded_rounds<true>(width) : banded_rounds<false>(width);
}

WindowsFn windows_fn(int width) {
  if (width <= rounds_width<1>()) return banded_windows_kernel<5>;
  if (width <= rounds_width<2>()) return banded_windows_kernel<8>;
  if (width <= rounds_width<4>()) return banded_windows_kernel<11>;
  return banded_windows_kernel<16>;
}

using SpreadFn = void (*)(const int*, const float*, const float*,
                          const float*, const int*, float*, Geometry,
                          EsKernel);

SpreadFn spread_fn(int rank, bool planned) {
  if (rank == 2) return planned ? spread_kernel<2, true>
                                : spread_kernel<2, false>;
  return planned ? spread_kernel<3, true> : spread_kernel<3, false>;
}

}  // namespace

// planned != 0: weights/starts are the planned artifact ([rank, slots, w]
// float32 and [rank, slots] int32) and coords is unused; planned == 0:
// coords is the [2 * rank, slots] payload (hi words, then lo words).
// values is [B2, slots]; out is [num_tiles, B2, *ext]. Returns the
// launch's CUDA error (0 on success; cudaErrorInvalidValue for a rank
// other than 2 or 3).
extern "C" int tnt_spread(int planned, const void* tile_bounds,
                          const void* values, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  if (g.rank != 2 && g.rank != 3) return (int)cudaErrorInvalidValue;
  const dim3 grid(tnt::num_tiles(g), (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  const SpreadFn fn = spread_fn(g.rank, planned != 0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, ip[tnt::kThreads], smem, (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const float*)values, (const float*)coords,
      (const float*)weights, (const int*)starts, (float*)out, g, k);
  return (int)cudaGetLastError();
}

// Rank-3 banded spread: coords [6, slots], values [B2, slots] (slot
// order), zorigins [num_chunks * subs], ws [3, slots, w] and st [3, slots]
// scratch for the windows (written here, then read by the spread);
// fused == 0: out [num_tiles, B2, *ext]; fused != 0: tw the twiddles
// [3][nt2][E2][n2] and out y [nt0, nt1, B2, E0, E1, n2] (B2 even, group
// 2). Launches the windows kernel, then the spread. Returns the first
// CUDA error.
extern "C" int tnt_spread_banded(int fused, const void* tile_bounds,
                                 const void* zorigins, const void* values,
                                 const void* coords, void* ws, void* st,
                                 const void* tw, void* out, const int* ip,
                                 const float* fp, void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank != 3 || bd.slab < 1 || bd.sublen < 1 || g.chunk % bd.sublen ||
      k.width < 1 || k.width > tnt::kMaxWidth || g.group < 1 ||
      g.group > 2 || ip[tnt::kThreads] != 32 * bd.slab ||
      ip[tnt::kThreads] > kMaxBandedThreads || (fused && g.group != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int kWindowThreads = 256;
  windows_fn(k.width)<<<(g.slots + kWindowThreads - 1) / kWindowThreads,
                        kWindowThreads, 0, s>>>(
      (const int*)tile_bounds, (const int*)zorigins, (const float*)coords,
      (float*)ws, (int*)st, g, k, bd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nslabs = (g.e[0] + bd.slab - 1) / bd.slab;
  const int outer = fused ? g.nt[0] * g.nt[1] : tnt::num_tiles(g);
  const dim3 grid(outer * nslabs, (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  const BandedFn fn = banded_fn(fused != 0, k.width);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, ip[tnt::kThreads], smem, s>>>(
      (const int*)tile_bounds, (const int*)zorigins, (const float*)values,
      (const float*)ws, (const int*)st, (const float*)tw, (float*)out, g, k,
      bd);
  return (int)cudaGetLastError();
}

extern "C" const char* tnt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
