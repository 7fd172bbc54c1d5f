// Spread (type-1 step 1) for NVIDIA Hopper: slot-order point values ->
// per-tile halo-padded blocks [num_tiles, B2, *ext] (float32, rank 1, 2
// or 3).
//
// Replaces nine Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_mats
//   and :_spread_kernel_mats (the rank-3 per-tile grid): precomputed
//     kernel windows, read by the spread as they are (tnt_spread,
//     planned);
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident
//   and :_spread_kernel (the rank-3 per-tile grid with its sub-chunk
//     fold): Horner or exp/sqrt on the two-float coordinates; here, at
//     ranks 2 and 3, a first kernel evaluates each slot's windows once
//     (windows_kernel, es_window from the extended-tile origin, the
//     arithmetic of the plain version and the TPU kernels), then the
//     same spread; at rank 1 the spread's own block evaluates them;
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_split
//   and :_spread_kernel_split: the same with separate coords and values
//     payloads, which the TPU takes for channel groups wider than one
//     8-row combined payload (2 * rank + B2 > 8: the source and points
//     gradients of training) and for slot-order values (values_slots:
//     PlannedNufft.normal, apply_from_slots); here the unplanned spread
//     at any B2, channel pairs on blockIdx.y, the last one partial.
//     Values are always read in slot order, so slot-order input only
//     skips the caller's gather.
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_banded
//   and :_spread_kernel_split_banded (the planned rank-3 binned level:
//     z-ordered binning on a coarse axis-0 geometry, sub-chunk j touching
//     only the axis-0 rows [zorigins[j], + band)); here the same two
//     kernels with kBanded (tnt_spread_banded);
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_split_banded_dfta
//     (the same with the axis-2 mode-DFT pass as an epilogue); kFused.
// The TPU needs the per-tile-grid and split twins because VMEM cannot
// hold the whole tile array and a DMA moves 8-row blocks. Hopper's limit
// is a block's 227 KB of shared memory, which one extended tile exceeds
// on many geometries (2D ext 308^2 at 150^2 modes, 3D ext (108, 108,
// 108) at 50^3, (32, 32, 80) at width 10): so no block owns a tile here,
// only an axis-0 slab of it.
//
// Design. One layout serves every geometry, banded or not. A block owns
// `slab` axis-0 rows of one tile (of its band's tile at the binned level)
// for a channel group of one or two, and of each row the axis-1 lines
// [q0, q0 + lines): all E1 lines wherever a row's planes fit half an SM,
// fewer where they do not (ext (278, 278, 278) at 135^3, for instance).
// Each warp owns one row's planes [lines][E2] (rank 3; [lines] at rank
// 2) in every channel of the group, in shared memory, and walks the
// tile's slots in order without a block barrier: it tests 32 slots at a
// time against its row (one ballot over the axis-0 window starts, and
// the axis-1 windows where the block owns only some lines), the hitting
// lanes load their slot's axis-0 weight, starts and values into
// registers and copy its axis-1 (and axis-2) windows into the warp's
// shared copy, and the warp takes the hits in slot order: each hit's
// window cells past axis 0 (w^2 at rank 3, w at rank 2) go across the
// lanes, lane l taking window offsets t = l + 32 q, one product per cell
// and channel. The lanes form the products of a few hits first, then add
// them hit by hit, a warp barrier after each hit ordering one cell's
// additions across lanes. Banded, the warp first skips, by one ballot
// per 32 sub-chunks, the sub-chunks whose band [zorigins[j], + band)
// misses its row. The fused variant gives each block (t0, t1, slab,
// pair) all nt2 tiles of its (t0, t1) in turn: it spreads tile t2's
// slab, then contracts its E2 axis with t2's wrap-aware, deconvolving
// twiddles (c, s - c, s + c: the Gauss three-multiply rotation of
// pallas_dft._pass_a_kernel) into y [nt0, nt1, B2, E0, E1, n2], written
// at t2 = 0 and added to after, so the t2 sum is a loop inside the block
// (no carry between blocks, no atomics).
//
// Determinism: each output cell is written by one warp, whose barrier
// orders its lanes, in slot order (and t2 order), with no atomics, so
// every result is bit-repeatable like the TPU kernel's. Shared-memory
// atomics (the cuFINUFFT SM method) would let all threads work on every
// slot, at the cost of that repeatability. A cell gets (w0 w1)(v w2) at
// rank 3 and w0 (v w1) at rank 2 with the products rounded as written
// (__fmul_rn, __fadd_rn): the rounding and slot order of the row-owner
// kernels this design replaced (one thread per row along the last axis,
// one block per whole tile), so their outputs are equal bit for bit.
//
// What bounds it on the H100: not memory traffic (each input is read
// about once; the windows kernel writes and the spread reads rank * (w +
// 1) words a slot) but the chain of each hit, about 17 shared-memory or
// shuffle operations for a channel pair, taken in order by one warp,
// with 12 to 16 warps per SM (a row's planes fill the shared memory):
// about 700 SM cycles per hit and warp at the 3D headlines (PERF.md).
// A slot hits w rows, so the work is w hits a slot and channel pair,
// 5.6e6 at 800,000 points and width 7. The row-owner design before it
// tested every slot in every row of its tile (49 of 576 rows at 3D ext
// (24, 24, 72) did work on a slot) at one block of 166 KB per SM.
//
// Rank 1 (the rank-1 branch of the same TPU kernels, chunk_contribution's
// sum(mats[0] * s), pallas_spread.py:174-175) has its own kernel,
// spread_line_kernel: a row of the layout above is one cell of a 1D tile.
// A warp owns a run of kLineRun = 64 consecutive cells of a tile's line,
// two a lane, for up to kMaxLineChannels = 8 channels, all summed in
// registers; a block of up to 32 warps owns a piece of the line (all of a
// tile of ext up to 2048: the 1D headline's 1032 cells take one block of
// 17 warps), for every channel of its group. The block takes the tile's
// slots in slot order, in batches of one slot a thread, into shared
// memory: each slot's start, and, where its window meets the piece, its
// w weights (loaded from the planned artifact, or evaluated from the
// coords by es_window, the arithmetic of the windows kernel it replaced)
// and its values. Nothing of the windows goes to device memory. Each
// warp then finds the batch's slots whose window meets its run, one
// ballot over 32 starts in shared memory (a slot meets at most two runs:
// w <= 16 < 64), and adds each hit to its cells in slot order, v * w[cell
// - s] with __fmul_rn/__fadd_rn, every channel from the one copy of the
// window. Two batch buffers take one block barrier a batch. One owner
// lane per cell, slot order, no atomics: bit-repeatable, and equal bit
// for bit to the two-kernel design it replaced (windows_kernel<1> wrote
// every slot's window, 32 B a slot, 0.34 GB at the headline, and each of
// a tile's 17 warps walked every slot's start in device memory, its
// channel pairs on grid.y). Wider channel counts take groups of eight on
// grid.y. What bounds it on the H100: not bytes (the coords or windows,
// the values and the tile array are each read or written once: 0.18 GB
// at the headline, B2 = 2) but the instructions a hit takes in its warp,
// about 45 at B2 = 2 in the SASS (the lanes' window tests, a shuffle,
// the shared loads of the values and weights, the products), with few
// lanes at work (about 7 of 64 cells a hit), then the ballot walk and
// the window evaluation (n_horner steps a cell). A branch-free hit (every
// lane loading and selecting) and uniform branches on the run's halves
// were both slower on the card (PERF.md). A block-wide scan into per-run
// lists was the alternative to the ballot walk: it costs the same
// ballots (one per run and 32 slots) plus a cross-warp prefix and a
// barrier, so the walk stays.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;

constexpr int kStrip = 8;  // rows per thread in the fused epilogue
// Threads of a spread block at most (kernels/spread.py): 16 warps, one
// per slab row, so that 128 registers a thread fit.
constexpr int kMaxRowThreads = 512;

// The widest kernel that kRounds lane rounds (w^2 <= 32 kRounds) serve.
template <int kRounds>
__host__ __device__ constexpr int rounds_width() {
  return kRounds == 1 ? 5 : kRounds == 2 ? 8 : kRounds == 4 ? 11 : 16;
}

// Every slot's kRank axis windows, one thread per slot of the chunks the
// tiles own: st [rank][slots] the window starts and ws [rank][slots][w]
// the weights. Unbanded: es_window from the extended-tile origin (the
// arithmetic of the plain version and the TPU kernels). Banded:
// es_window_exact, axis 0 counted from the slot's band origin.
template <int kRank, int kW, bool kBanded>
__global__ void windows_kernel(const int* __restrict__ tile_bounds,
                               const int* __restrict__ zorigins,
                               const float* __restrict__ coords,
                               float* __restrict__ ws, int* __restrict__ st,
                               Geometry g, EsKernel k, tnt::Band bd) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = tnt::num_tiles(g);
  if (slot >= g.slots) return;
  const int kc = slot / g.chunk;
  if (kc >= tile_bounds[nt]) return;  // a chunk no tile owns
  float origin[kRank];
  tnt::tile_origins<kRank>(g, tnt::owner_tile(tile_bounds, nt, kc), origin);
  if constexpr (kBanded)
    origin[0] = __fadd_rn(origin[0], (float)zorigins[slot / bd.sublen]);
  float w[kW];
#pragma unroll
  for (int d = 0; d < kRank; ++d) {
    const float hi = coords[(size_t)d * g.slots + slot];
    const float lo = coords[(size_t)(kRank + d) * g.slots + slot];
    if constexpr (kBanded)
      st[(size_t)d * g.slots + slot] =
          tnt::es_window_exact<kW>(hi, lo, origin[d], k, w);
    else
      st[(size_t)d * g.slots + slot] =
          tnt::es_window<kW>(hi, lo, origin[d], k, w);
    float* dst = ws + ((size_t)d * g.slots + slot) * k.width;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (j < k.width) dst[j] = w[j];
  }
}

// One warp adds tile `tile`'s slots into its row: extended-tile axis-0
// row a0, axis-1 lines [q0, q0 + nq), the planes p0 (channel c0) and p1
// (c0 + 1, when nc = 2), each [nq][line] (line: E2 at rank 3, 1 at rank
// 2). It walks the tile's slots in order (banded: the sub-chunks whose
// band holds the row), tests 32 slots at a time against the row (one
// ballot) and takes the hits in slot order: lane l covers window offsets
// t = l + 32 q of the hit's axis-1 (rank 2) or (axis-1, axis-2) window
// (d1 = t / w, d2 = t % w) in every channel, with a warp barrier after
// each hit ordering one cell's additions across lanes. A cell gets
// (w0 w1)(v w2) at rank 3 and w0 (v w1) at rank 2, each product rounded
// as written. mywin holds the warp's copy of its 32 slots' windows past
// axis 0, [32][rank - 1][w].
template <int kRank, bool kBanded, int kRounds>
__device__ __forceinline__ void row_accumulate(
    int tile, int a0, int q0, int nq, int c0, int nc,
    const int* __restrict__ tile_bounds, const int* __restrict__ zorigins,
    const float* __restrict__ values, const float* __restrict__ ws,
    const int* __restrict__ st, float* __restrict__ p0,
    float* __restrict__ p1, float* __restrict__ mywin, const Geometry& g,
    const EsKernel& k, const tnt::Band& bd) {
  // Hits whose products a lane forms before it adds them, in order.
  constexpr int kStep = kRounds >= 8 ? 1 : 8 / kRounds;
  constexpr int kWins = kRank - 1;
  const int w = k.width;
  const int line = kRank == 3 ? g.e[2] : 1;
  const int lane = threadIdx.x & 31;
  const size_t slots = g.slots;
  if constexpr (kBanded) {  // a banded block owns whole rows
    q0 = 0;
    nq = g.e[1];
  }
  // Where the block owns only some of the axis-1 lines, a slot must also
  // meet them.
  const bool split = !kBanded && nq < g.e[1];
  const float* v0 = values + (size_t)c0 * slots;
  const float* v1 = v0 + slots;
  int d1[kRounds], d2[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int t = lane + 32 * q;
    if constexpr (kRank == 3) {
      d1[q] = t < w * w ? t / w : -1;
      d2[q] = t - (t / w) * w;
    } else {
      d1[q] = t < w ? t : -1;
      d2[q] = 0;
    }
  }
  // The tile's slots in order, by sub-chunks (banded: those whose band
  // holds the row, found by one ballot per 32 sub-chunks; unbanded: a
  // sub-chunk is a chunk, and every one holds the row).
  const int sublen = kBanded ? bd.sublen : g.chunk;
  const int subs = g.chunk / sublen;
  const int sbeg = tile_bounds[tile] * subs;
  const int send = tile_bounds[tile + 1] * subs;
  for (int sc0 = sbeg; sc0 < send; sc0 += 32) {
    const int sc = sc0 + lane;
    const int zo = kBanded && sc < send ? zorigins[sc] : 0;
    unsigned held = __ballot_sync(
        0xffffffffu,
        sc < send && (!kBanded || (unsigned)(a0 - zo) < (unsigned)bd.band));
    while (held) {
      const int hs = __ffs(held) - 1;
      held &= held - 1u;
      // The row in the sub-chunk's band (unbanded: in the tile).
      const int row = a0 - __shfl_sync(0xffffffffu, zo, hs);
      const int beg = (sc0 + hs) * sublen, end = beg + sublen;
      for (int base = beg; base < end; base += 32) {
        // Each lane loads the parameters of its own slot, if it hits the
        // row, and the hits go out to the warp by shuffles.
        const int i = base + lane;
        const int d0 = i < end ? row - st[i] : -1;
        bool hit = (unsigned)d0 < (unsigned)w;
        if (split && hit) {
          const int s1 = st[slots + i];
          hit = s1 < q0 + nq && s1 + w > q0;
        }
        unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m == 0u) continue;
        float mw0 = 0.0f, mv0 = 0.0f, mv1 = 0.0f;
        int ms1 = 0, ms2 = 0;
        __syncwarp();  // the previous group's windows are consumed
        if (hit) {
          mw0 = ws[(size_t)i * w + d0];
          ms1 = st[slots + i] - q0;  // from the block's first line
          if (kRank == 3) ms2 = st[2 * slots + i];
          mv0 = v0[i];
          mv1 = nc > 1 ? v1[i] : 0.0f;
          const float* src1 = ws + (slots + i) * w;
          const float* src2 = src1 + slots * w;  // rank 3
          float* dst = mywin + lane * kWins * w;
          for (int j = 0; j < w; ++j) {
            dst[j] = src1[j];
            if (kRank == 3) dst[w + j] = src2[j];
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
            const int src = any ? __ffs(m) - 1 : 0;
            if (any) m &= m - 1u;
            const float w0 = __shfl_sync(0xffffffffu, mw0, src);
            const float x0 = __shfl_sync(0xffffffffu, mv0, src);
            const float x1 = __shfl_sync(0xffffffffu, mv1, src);
            const int s1 = __shfl_sync(0xffffffffu, ms1, src);
            const int s2 = __shfl_sync(0xffffffffu, ms2, src);
            const float* w1 = mywin + src * kWins * w;
            const float* w2 = w1 + w;
#pragma unroll
            for (int q = 0; q < kRounds; ++q) {
              const int c1 = s1 + d1[q], c2 = s2 + d2[q];
              const bool ok = any && d1[q] >= 0 &&
                              (unsigned)c1 < (unsigned)nq &&
                              (kRank == 2 || (unsigned)c2 < (unsigned)line);
              at[h][q] = ok ? c1 * line + c2 : -1;
              float wl, wz;
              if constexpr (kRank == 3) {
                wl = ok ? __fmul_rn(w0, w1[d1[q]]) : 0.0f;
                wz = ok ? w2[d2[q]] : 0.0f;
              } else {
                wl = ok ? w0 : 0.0f;
                wz = ok ? w1[d1[q]] : 0.0f;
              }
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
              old0[q] = p0[a];
              if (nc > 1) old1[q] = p1[a];
            }
#pragma unroll
            for (int q = 0; q < kRounds; ++q) {
              if (at[h][q] < 0) continue;
              p0[at[h][q]] = __fadd_rn(old0[q], val0[h][q]);
              if (nc > 1) p1[at[h][q]] = __fadd_rn(old1[q], val1[h][q]);
            }
            __syncwarp();
          }
        }
      }
    }
  }
}

// The spread: block (outer * nslabs + slab) * nqs + piece, channel group
// of one or two; one warp per slab row, 32 * slab threads, each row's
// planes [lines][line] and the warps' windows [32][rank - 1][w] in
// shared memory; ws/st the slots' windows (the planned artifact or
// windows_kernel's). kFused = false: outer is the tile, and the block
// writes out[tile][c0..][slab rows][lines]. kFused = true (banded, rank
// 3, all E1 lines): outer is t01, the slab is spread for each t2 in turn
// and contracted with that tile's twiddles tw [3][nt2][E2][n2] into
// y[t0][t1][c0, c0 + 1][slab rows][E1][n2].
template <int kRank, bool kBanded, bool kFused, int kRounds>
__global__ void __launch_bounds__(kMaxRowThreads)
    spread_rows_kernel(const int* __restrict__ tile_bounds,
                       const int* __restrict__ zorigins,
                       const float* __restrict__ values,
                       const float* __restrict__ ws,
                       const int* __restrict__ st,
                       const float* __restrict__ tw,
                       float* __restrict__ out, Geometry g, EsKernel k,
                       tnt::Band bd) {
  extern __shared__ float acc[];
  const int e0 = g.e[0], e1 = g.e[1], e2 = g.e[2];
  const int line = kRank == 3 ? e2 : 1;
  const int nslabs = (e0 + bd.slab - 1) / bd.slab;
  const int nqs = (e1 + bd.lines - 1) / bd.lines;
  const int piece = blockIdx.x % nqs;
  const int slab = (blockIdx.x / nqs) % nslabs;
  const int outer = blockIdx.x / nqs / nslabs;
  const int r0 = slab * bd.slab;
  const int nrows = min(bd.slab, e0 - r0);
  const int q0 = piece * bd.lines;
  const int nq = min(bd.lines, e1 - q0);
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int sub = nq * line;                  // a row's floats, per channel
  const int cells = nrows * sub;              // per channel
  const int stride = bd.slab * bd.lines * line;  // channel stride of acc
  const int warp = threadIdx.x >> 5;
  float* p0 = acc + warp * sub;
  float* p1 = p0 + stride;
  float* mywin = acc + g.group * stride + warp * 32 * (kRank - 1) * k.width;
  if constexpr (!kFused) {
    const int tile = outer;
    for (int c = 0; c < nc; ++c)
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        acc[c * stride + i] = 0.0f;
    __syncthreads();
    if (warp < nrows)
      row_accumulate<kRank, kBanded, kRounds>(
          tile, r0 + warp, q0, nq, c0, nc, tile_bounds, zorigins, values,
          ws, st, p0, p1, mywin, g, k, bd);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      float* dst = out + ((((size_t)tile * g.batch2 + c0 + c) * e0 + r0) *
                              e1 + q0) * line;
      for (int r = 0; r < nrows; ++r)
        for (int i = threadIdx.x; i < sub; i += blockDim.x)
          dst[(size_t)r * e1 * line + i] = acc[c * stride + r * sub + i];
    }
  } else {
    const int t01 = outer;
    const int nt2 = g.nt[2], n2 = bd.n2;
    const size_t plane = (size_t)e1 * n2;
    float* yr = out + (((size_t)t01 * g.batch2 + c0) * e0 + r0) * plane;
    float* yi = yr + (size_t)e0 * plane;
    for (int t2 = 0; t2 < nt2; ++t2) {
      for (int c = 0; c < 2; ++c)
        for (int i = threadIdx.x; i < cells; i += blockDim.x)
          acc[c * stride + i] = 0.0f;
      __syncthreads();
      if (warp < nrows)
        row_accumulate<kRank, kBanded, kRounds>(
            t01 * nt2 + t2, r0 + warp, 0, e1, c0, 2, tile_bounds, zorigins,
            values, ws, st, p0, p1, mywin, g, k, bd);
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
        const int l0 = (o / n2) * kStrip;
        const int nr = min(kStrip, rows - l0);
        float t1[kStrip], t2s[kStrip], t3[kStrip];
#pragma unroll
        for (int r = 0; r < kStrip; ++r) t1[r] = t2s[r] = t3[r] = 0.0f;
        for (int e = 0; e < e2; ++e) {
          const size_t at = (size_t)e * n2 + m;
          const float c = cw[at], smc = smcw[at], spc = spcw[at];
#pragma unroll
          for (int r = 0; r < kStrip; ++r) {
            if (r < nr) {
              const float a = acc[(l0 + r) * e2 + e];
              const float bi = acc[stride + (l0 + r) * e2 + e];
              t1[r] += (a + bi) * c;
              t2s[r] += a * smc;
              t3[r] += bi * spc;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kStrip; ++r) {
          if (r < nr) {
            const size_t at = (size_t)(l0 + r) * n2 + m;
            const float vr = t1[r] - t3[r], vi = t1[r] + t2s[r];
            yr[at] = t2 == 0 ? vr : yr[at] + vr;
            yi[at] = t2 == 0 ? vi : yi[at] + vi;
          }
        }
      }
      __syncthreads();  // acc is zeroed again for the next t2
    }
  }
}

// Cells of a tile's line a rank-1 warp owns: kLineCells a lane.
constexpr int kLineCells = 2;
constexpr int kLineRun = 32 * kLineCells;
// Threads of a rank-1 spread block at most: 32 warps, a 2048-cell piece
// of a line (every tile of ext up to 2048 in one block), one slot each
// in a batch.
constexpr int kMaxLineThreads = 1024;
// Channels a rank-1 block serves from one evaluation of its windows.
constexpr int kMaxLineChannels = 8;

// Blocks of one tile's line: bd.slab warps a block, kLineRun cells a warp.
__host__ __device__ inline int line_pieces(const Geometry& g,
                                           const tnt::Band& bd) {
  const int runs = (g.e[0] + kLineRun - 1) / kLineRun;
  return (runs + bd.slab - 1) / bd.slab;
}

// Shared memory of a rank-1 block: two batches of blockDim.x slots, each
// slot's values (kChan floats), window start and w weights.
__host__ __device__ inline int line_smem(int threads, int chan, int width) {
  return 2 * threads * (chan + 1 + width) * 4;
}

// kChan channel values of one slot from shared memory, 16 or 8 bytes at a
// time (p is aligned to kChan floats).
template <int kChan>
__device__ __forceinline__ void load_channels(const float* p, float* v) {
  if constexpr (kChan % 4 == 0) {
#pragma unroll
    for (int c = 0; c < kChan; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      v[c] = x.x; v[c + 1] = x.y; v[c + 2] = x.z; v[c + 3] = x.w;
    }
  } else if constexpr (kChan == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// The rank-1 spread (source note above): block (tile * pieces + piece,
// channel group of up to kChan), bd.slab warps; warp `warp` owns cells
// [c0, c0 + kLineRun), c0 = (piece * slab + warp) * kLineRun, lane l the
// cells c0 + l + 32 q, q < kLineCells, for every channel of the group,
// in registers. The block takes the tile's slots in batches of
// blockDim.x, one a thread, into shared memory (two buffers, so one
// barrier a batch): each slot's window start, and, where the window
// meets the piece, its weights (ws, the planned artifact [slots][w], or
// es_window<kW> from coords, the arithmetic of the plain version) and
// its values. Each warp then finds the batch's slots whose window meets
// its run, one ballot over 32 shared starts, and adds them in slot
// order. Unplanned, coords is [2, slots] and ws/st are null.
template <int kW, int kChan>
__global__ void __launch_bounds__(kMaxLineThreads)
    spread_line_kernel(const int* __restrict__ tile_bounds,
                       const float* __restrict__ values,
                       const float* __restrict__ coords,
                       const float* __restrict__ ws,
                       const int* __restrict__ st, float* __restrict__ out,
                       Geometry g, EsKernel k, tnt::Band bd) {
  extern __shared__ float4 line4[];
  const int nb = blockDim.x;  // slots a batch
  const int w = k.width;
  float* sv = reinterpret_cast<float*>(line4);          // [2][nb][kChan]
  int* sst = reinterpret_cast<int*>(sv + 2 * nb * kChan);  // [2][nb]
  float* sw = reinterpret_cast<float*>(sst + 2 * nb);   // [2][nb][w]
  const int e0 = g.e[0];
  const int pieces = line_pieces(g, bd);
  const int tile = blockIdx.x / pieces;
  const int p0 = (blockIdx.x % pieces) * bd.slab * kLineRun;
  const int pend = p0 + bd.slab * kLineRun;  // past the piece's cells
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = p0 + warp * kLineRun;
  const bool owns = c0 < e0;  // warp-uniform
  const int ch = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - ch);
  const size_t slots = g.slots;
  float origin;
  tnt::tile_origins<1>(g, tile, &origin);
  float acc[kLineCells][kChan];
#pragma unroll
  for (int q = 0; q < kLineCells; ++q)
#pragma unroll
    for (int c = 0; c < kChan; ++c) acc[q][c] = 0.0f;
  const int beg = tile_bounds[tile] * g.chunk;
  const int end = tile_bounds[tile + 1] * g.chunk;
  int buf = 0;
  for (int base = beg; base < end; base += nb, buf ^= 1) {
    const int n = min(nb, end - base);
    float* bv = sv + buf * nb * kChan;
    int* bs = sst + buf * nb;
    float* bw = sw + buf * nb * w;
    // The batch into shared memory. The buffer was last read two batches
    // ago, before the previous barrier.
    if (ws != nullptr)
      for (int x = threadIdx.x; x < n * w; x += nb)
        bw[x] = ws[(size_t)base * w + x];
    const int e = threadIdx.x, i = base + e;
    if (e < n) {
      // Padded slots start far outside the tile (binning.SENTINEL).
      const int s0 =
          ws != nullptr ? st[i] : tnt::es_start(coords[i], origin, k);
      bs[e] = s0;
      if (s0 < pend && s0 + w > p0) {
        if (ws == nullptr)
          tnt::es_window<kW>(coords[i], coords[slots + i], origin, k,
                             bw + e * w);
#pragma unroll
        for (int c = 0; c < kChan; ++c)
          if (c < nc) bv[e * kChan + c] = values[(ch + c) * slots + i];
      }
    }
    __syncthreads();
    if (!owns) continue;
    for (int g0 = 0; g0 < n; g0 += 32) {
      const int j = g0 + lane;
      // The slot's window start from the run's first cell.
      const int d = j < n ? bs[j] - c0 : kLineRun;
      unsigned m = __ballot_sync(0xffffffffu, d < kLineRun && d + w > 0);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1u;
        const int ds = __shfl_sync(0xffffffffu, d, src);
        const int hit = g0 + src;
        float v[kChan];
        load_channels<kChan>(bv + hit * kChan, v);
        const float* wh = bw + hit * w;
#pragma unroll
        for (int q = 0; q < kLineCells; ++q) {
          const int t = lane + 32 * q - ds;  // the cell's window offset
          if ((unsigned)t < (unsigned)w) {
            const float wt = wh[t];
#pragma unroll
            for (int c = 0; c < kChan; ++c)
              if (c < nc) acc[q][c] = __fadd_rn(acc[q][c], __fmul_rn(v[c], wt));
          }
        }
      }
    }
  }
  if (!owns) return;
  float* dst = out + ((size_t)tile * g.batch2 + ch) * e0;
#pragma unroll
  for (int q = 0; q < kLineCells; ++q) {
    const int cell = c0 + lane + 32 * q;
    if (cell < e0) {
#pragma unroll
      for (int c = 0; c < kChan; ++c)
        if (c < nc) dst[(size_t)c * e0 + cell] = acc[q][c];
    }
  }
}

using LineFn = void (*)(const int*, const float*, const float*, const float*,
                        const int*, float*, Geometry, EsKernel, tnt::Band);

template <int kW>
LineFn line_fn_chan(int chan) {
  return chan == 1   ? spread_line_kernel<kW, 1>
         : chan == 2 ? spread_line_kernel<kW, 2>
         : chan == 4 ? spread_line_kernel<kW, 4>
                     : spread_line_kernel<kW, 8>;
}

// The channels a rank-1 block holds (kernels/spread.py:line_channels):
// the group rounded up to a power of two.
inline int line_channels(int group) {
  return group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
}

// Launches the rank-1 spread on grid (tiles * line_pieces, channel
// groups) after checking the layout it takes; returns the CUDA error.
cudaError_t launch_line(const int* tile_bounds, const float* values,
                        const float* coords, const float* ws, const int* st,
                        float* out, const Geometry& g, const EsKernel& k,
                        const tnt::Band& bd, const int* ip, cudaStream_t s) {
  const int threads = ip[tnt::kThreads], smem = ip[tnt::kSmem];
  const int chan = line_channels(g.group);
  if (bd.slab < 1 || threads != 32 * bd.slab || threads > kMaxLineThreads ||
      k.width < 1 || k.width > tnt::kMaxWidth || g.group < 1 ||
      g.group > kMaxLineChannels ||
      smem != line_smem(threads, chan, k.width))
    return cudaErrorInvalidValue;
  const LineFn fn = k.width <= 8 ? line_fn_chan<8>(chan)
                                 : line_fn_chan<tnt::kMaxWidth>(chan);
  const dim3 grid(tnt::num_tiles(g) * line_pieces(g, bd),
                  (g.batch2 + g.group - 1) / g.group);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, threads, smem, s>>>(tile_bounds, values, coords, ws, st, out, g,
                                 k, bd);
  return cudaGetLastError();
}

using RowsFn = void (*)(const int*, const int*, const float*, const float*,
                        const int*, const float*, float*, Geometry, EsKernel,
                        tnt::Band);
using WindowsFn = void (*)(const int*, const int*, const float*, float*,
                           int*, Geometry, EsKernel, tnt::Band);

template <int kRank, bool kBanded, bool kFused>
RowsFn rows_fn(int width) {
  if constexpr (kRank == 2) {
    return spread_rows_kernel<2, kBanded, kFused, 1>;  // w <= 32: one round
  } else {
    if (width <= rounds_width<1>())
      return spread_rows_kernel<3, kBanded, kFused, 1>;
    if (width <= rounds_width<2>())
      return spread_rows_kernel<3, kBanded, kFused, 2>;
    if (width <= rounds_width<4>())
      return spread_rows_kernel<3, kBanded, kFused, 4>;
    return spread_rows_kernel<3, kBanded, kFused, 8>;
  }
}

template <int kRank, bool kBanded>
WindowsFn windows_fn(int width) {
  if (width <= 5) return windows_kernel<kRank, 5, kBanded>;
  if (width <= 8) return windows_kernel<kRank, 8, kBanded>;
  if (width <= 11) return windows_kernel<kRank, 11, kBanded>;
  return windows_kernel<kRank, 16, kBanded>;
}

// The launch parameters the rank-2 and rank-3 spreads take: a row-slab
// layout with one warp per slab row, channel groups of one or two, a
// width the kernels are built for.
bool rows_valid(const Geometry& g, const EsKernel& k, const tnt::Band& bd,
                int threads) {
  return bd.slab >= 1 && bd.lines >= 1 && bd.lines <= g.e[1] &&
         k.width >= 1 && k.width <= tnt::kMaxWidth && g.group >= 1 &&
         g.group <= 2 && threads == 32 * bd.slab &&
         threads <= kMaxRowThreads;
}

// Launches the windows kernel (into ws/st) where `windows`, then the
// spread on grid (outer * nslabs * nqs, channel groups).
cudaError_t launch_rows(WindowsFn windows, RowsFn fn, int outer,
                        const int* tile_bounds, const int* zorigins,
                        const float* values, const float* coords, float* ws,
                        int* st, const float* tw, float* out,
                        const Geometry& g, const EsKernel& k,
                        const tnt::Band& bd, const int* ip,
                        cudaStream_t s) {
  if (windows != nullptr) {
    constexpr int kWindowThreads = 256;
    windows<<<(g.slots + kWindowThreads - 1) / kWindowThreads,
              kWindowThreads, 0, s>>>(tile_bounds, zorigins, coords, ws, st,
                                      g, k, bd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int nslabs = (g.e[0] + bd.slab - 1) / bd.slab;
  const int nqs = (g.e[1] + bd.lines - 1) / bd.lines;
  const dim3 grid(outer * nslabs * nqs, (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, ip[tnt::kThreads], smem, s>>>(tile_bounds, zorigins, values, ws,
                                           st, tw, out, g, k, bd);
  return cudaGetLastError();
}

}  // namespace

// planned != 0: weights/starts are the planned artifact ([rank, slots, w]
// float32 and [rank, slots] int32) and coords is unused; planned == 0:
// coords is the [2 * rank, slots] payload (hi words, then lo words) and,
// at ranks 2 and 3, weights/starts are scratch of the same shapes, which
// a first kernel fills with the slots' windows (rank 1 evaluates them in
// the spread and takes null). values is [B2, slots]; out is [num_tiles,
// B2, *ext]. Rank 1 takes spread_line_kernel (bd.slab warps a block, one
// line, channel groups of up to kMaxLineChannels), ranks 2 and 3
// spread_rows_kernel. Returns the first CUDA error (0 on success;
// cudaErrorInvalidValue for a rank other than 1, 2 or 3 or a layout the
// kernels do not take).
extern "C" int tnt_spread(int planned, const void* tile_bounds,
                          const void* values, const void* coords,
                          void* weights, void* starts, void* out,
                          const int* ip, const float* fp, void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank == 1)
    return (int)launch_line(
        (const int*)tile_bounds, (const float*)values,
        planned ? nullptr : (const float*)coords,
        planned ? (const float*)weights : nullptr,
        planned ? (const int*)starts : nullptr, (float*)out, g, k, bd, ip,
        (cudaStream_t)stream);
  if (g.rank < 2 || g.rank > 3 || !rows_valid(g, k, bd, ip[tnt::kThreads]))
    return (int)cudaErrorInvalidValue;
  WindowsFn windows = nullptr;
  if (!planned)
    windows = g.rank == 2 ? windows_fn<2, false>(k.width)
                          : windows_fn<3, false>(k.width);
  const RowsFn fn = g.rank == 2 ? rows_fn<2, false, false>(k.width)
                                : rows_fn<3, false, false>(k.width);
  return (int)launch_rows(
      windows, fn, tnt::num_tiles(g), (const int*)tile_bounds, nullptr,
      (const float*)values, (const float*)coords, (float*)weights,
      (int*)starts, nullptr, (float*)out, g, k, bd, ip,
      (cudaStream_t)stream);
}

// Rank-3 banded spread: coords [6, slots], values [B2, slots] (slot
// order), zorigins [num_chunks * subs], ws [3, slots, w] and st [3, slots]
// scratch for the windows (written here, then read by the spread);
// fused == 0: out [num_tiles, B2, *ext]; fused != 0: tw the twiddles
// [3][nt2][E2][n2] and out y [nt0, nt1, B2, E0, E1, n2] (B2 even, group
// 2). A block owns all E1 lines of its rows. Launches the windows kernel,
// then the spread.
// Returns the first CUDA error.
extern "C" int tnt_spread_banded(int fused, const void* tile_bounds,
                                 const void* zorigins, const void* values,
                                 const void* coords, void* ws, void* st,
                                 const void* tw, void* out, const int* ip,
                                 const float* fp, void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank != 3 || bd.sublen < 1 || g.chunk % bd.sublen ||
      !rows_valid(g, k, bd, ip[tnt::kThreads]) ||
      bd.lines != g.e[1] || (fused && g.group != 2))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rows(
      windows_fn<3, true>(k.width),
      fused ? rows_fn<3, true, true>(k.width)
            : rows_fn<3, true, false>(k.width),
      fused ? g.nt[0] * g.nt[1] : tnt::num_tiles(g), (const int*)tile_bounds,
      (const int*)zorigins, (const float*)values, (const float*)coords,
      (float*)ws, (int*)st, (const float*)tw, (float*)out, g, k, bd, ip,
      (cudaStream_t)stream);
}

extern "C" const char* tnt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
