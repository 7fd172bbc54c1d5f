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
// the 227 KB a block may hold, so no block can own a whole tile. A block
// owns one axis-0 slab of a tile's rows for a channel pair instead
// (kSlab rows; 14 at the headline), walks the tile's sub-chunks and
// stages only those whose band [zorigins[j], + band) meets its slab: the
// band bounds each block's work by the band, not by E0, as it bounded
// the TPU kernel's fold. Within a staged sub-chunk, as above, each
// thread owns one (channel, e0, e1) row of the slab; the windows come
// from es_window_exact (the kernel argument from the fine-grid row, which
// does not round where the TPU kernel's (hi - origin) - zo does), axis
// 0's counted from the band origin, and rows outside [zo, zo + band) take
// nothing. Band
// origins need not be monotone within a tile (points keep arrival order
// within a z-cell), so every sub-chunk is tested. The fused variant
// gives each block (t0, t1, slab, pair) all nt2 tiles of its (t0, t1)
// in turn: it spreads tile t2's slab, then contracts its E2 axis with
// t2's wrap-aware, deconvolving twiddles (c, s - c, s + c: the Gauss
// three-multiply rotation of pallas_dft._pass_a_kernel) into
// y [nt0, nt1, B2, E0, E1, n2], written at t2 = 0 and added to after, so
// the t2 sum is a loop inside the block (no carry between blocks, no
// atomics).
//
// Determinism: each output cell is written by exactly one thread, in slot
// order (and t2 order), with no atomics, so every result is
// bit-repeatable like the TPU kernel's. Shared-memory atomics (the
// cuFINUFFT SM method) would let all threads work on every slot; that is
// a later performance change.
//
// What bounds it on the H100: the kernels are latency- and
// occupancy-bound, not bound by memory traffic (each input is read about
// once; the banded kernels re-read a sub-chunk's coords once per slab it
// meets). At the 2D headline (8 x 8 tiles) the grid has 64 blocks for 132
// SMs, and only the rows a slot's window covers do work on it: w of E0
// rows at rank 2, w^2 = 49 of the 576 rows at 3D ext (24, 24, 72); each
// thread still tests every staged slot. At rank 3 a block of 166-207 KB
// allows one block per SM. The design keeps the traffic minimal
// (per-slot windows or coordinates instead of the TPU path's dense,
// mostly-zero [sum(E), chunk] matrices) and leaves occupancy to later
// work.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;

constexpr int kSub = 128;  // slots staged at a time (kernels/spread.py)
constexpr int kStrip = 8;  // rows per thread in the fused epilogue

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

// Adds tile `tile`'s staged sub-chunks into the slab block
// acc[nc][nrows][E1][E2] of axis-0 rows [r0, r0 + nrows), channels c0..:
// every sub-chunk whose band meets the slab is staged (windows evaluated
// from the coordinates, axis 0 relative to the band origin), and each
// thread owning a (channel, e0, e1) row adds its slots in slot order.
// Starts with a barrier, so the caller's zero-fill of acc is complete.
__device__ void banded_accumulate(int tile, int r0, int nrows, int c0,
                                  int nc, const int* __restrict__ tile_bounds,
                                  const int* __restrict__ zorigins,
                                  const float* __restrict__ values,
                                  const float* __restrict__ coords,
                                  float* acc, float* sw, float* sv, int* ss,
                                  const Geometry& g, const EsKernel& k,
                                  const tnt::Band& bd) {
  const int w = k.width;
  const int e1 = g.e[1], len = g.e[2];
  const int rows = nrows * e1;  // rows per channel
  const int subs = g.chunk / bd.sublen;
  float origin[3];
  tnt::tile_origins<3>(g, tile, origin);
  const int row = threadIdx.x;
  const bool owner = row < nc * rows;
  const int b = row / rows;
  const int lr = row - b * rows;
  const int a0 = r0 + lr / e1;  // the extended-tile axis-0 row
  const int a1 = lr % e1;
  float* arow = acc + row * len;
  const int kbeg = tile_bounds[tile];
  const int kend = tile_bounds[tile + 1];
  for (int kc = kbeg; kc < kend; ++kc) {
    for (int j = 0; j < subs; ++j) {
      const int zo = zorigins[kc * subs + j];
      if (zo >= r0 + nrows || zo + bd.band <= r0) continue;  // uniform
      const int base = kc * g.chunk + j * bd.sublen;
      __syncthreads();  // acc zeroed, or the previous piece consumed
      for (int i = threadIdx.x; i < bd.sublen; i += blockDim.x) {
        const int slot = base + i;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          ss[d * kSub + i] = tnt::es_window_exact(
              coords[(size_t)d * g.slots + slot],
              coords[(size_t)(3 + d) * g.slots + slot],
              d == 0 ? __fadd_rn(origin[0], (float)zo) : origin[d], k,
              sw + (d * kSub + i) * w);
        for (int c = 0; c < nc; ++c)
          sv[c * kSub + i] = values[(size_t)(c0 + c) * g.slots + slot];
      }
      __syncthreads();
      const int q0 = a0 - zo;  // this row in the band's coordinates
      if (owner && q0 >= 0 && q0 < bd.band) {
        for (int i = 0; i < bd.sublen; ++i) {
          const int d0 = q0 - ss[i];
          const int d1 = a1 - ss[kSub + i];
          if ((unsigned)d0 >= (unsigned)w || (unsigned)d1 >= (unsigned)w)
            continue;
          const float wl = __fmul_rn(sw[i * w + d0],
                                     sw[(kSub + i) * w + d1]);
          const float v = sv[b * kSub + i];
          const int s = ss[2 * kSub + i];
          const float* wlast = sw + (2 * kSub + i) * w;
          for (int q = 0; q < w; ++q) {
            const int col = s + q;
            if ((unsigned)col < (unsigned)len)
              arow[col] = __fadd_rn(arow[col],
                                    __fmul_rn(wl, __fmul_rn(v, wlast[q])));
          }
        }
      }
    }
  }
}

// Rank-3 banded spread. Block (tile * nslabs + slab, channel group) ->
// out[tile][c0..][slab rows] (kFused = false); block (t01 * nslabs +
// slab, channel pair) -> y[t0][t1][c0, c0 + 1][slab rows][E1][n2], the
// slab spread for each t2 in turn and contracted with that tile's
// twiddles tw [3][nt2][E2][n2] (kFused = true).
template <bool kFused>
__global__ void spread_banded_kernel(const int* __restrict__ tile_bounds,
                                     const int* __restrict__ zorigins,
                                     const float* __restrict__ values,
                                     const float* __restrict__ coords,
                                     const float* __restrict__ tw,
                                     float* __restrict__ out, Geometry g,
                                     EsKernel k, tnt::Band bd) {
  extern __shared__ float smem[];
  const int w = k.width;
  const int e0 = g.e[0], e1 = g.e[1], e2 = g.e[2];
  const int nslabs = (e0 + bd.slab - 1) / bd.slab;
  const int slab = blockIdx.x % nslabs;
  const int r0 = slab * bd.slab;
  const int nrows = min(bd.slab, e0 - r0);
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int cells = nrows * e1 * e2;  // per channel
  float* acc = smem;                                 // [group][slab rows]
  float* sw = acc + g.group * bd.slab * e1 * e2;     // [3][kSub][w]
  float* sv = sw + 3 * kSub * w;                     // [group][kSub]
  int* ss = reinterpret_cast<int*>(sv + g.group * kSub);  // [3][kSub]
  if (!kFused) {
    const int tile = blockIdx.x / nslabs;
    for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) acc[i] = 0.0f;
    banded_accumulate(tile, r0, nrows, c0, nc, tile_bounds, zorigins,
                      values, coords, acc, sw, sv, ss, g, k, bd);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      float* dst = out + (((size_t)tile * g.batch2 + c0 + c) * e0 + r0) *
                             e1 * e2;
      for (int i = threadIdx.x; i < cells; i += blockDim.x)
        dst[i] = acc[c * cells + i];
    }
    return;
  }
  const int t01 = blockIdx.x / nslabs;
  const int nt2 = g.nt[2], n2 = bd.n2;
  const size_t plane = (size_t)e1 * n2;
  float* yr = out + (((size_t)t01 * g.batch2 + c0) * e0 + r0) * plane;
  float* yi = yr + (size_t)e0 * plane;
  for (int t2 = 0; t2 < nt2; ++t2) {
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) acc[i] = 0.0f;
    banded_accumulate(t01 * nt2 + t2, r0, nrows, c0, 2, tile_bounds,
                      zorigins, values, coords, acc, sw, sv, ss, g, k, bd);
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
            const float bi = acc[cells + (r0 + r) * e2 + e];
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
// order), zorigins [num_chunks * subs]; fused == 0: out [num_tiles, B2,
// *ext]; fused != 0: tw the twiddles [3][nt2][E2][n2] and out
// y [nt0, nt1, B2, E0, E1, n2] (B2 even, group 2). Returns the launch's
// CUDA error.
extern "C" int tnt_spread_banded(int fused, const void* tile_bounds,
                                 const void* zorigins, const void* values,
                                 const void* coords, const void* tw,
                                 void* out, const int* ip, const float* fp,
                                 void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank != 3 || bd.slab < 1 || bd.sublen < 1 ||
      bd.sublen > kSub || g.chunk % bd.sublen)
    return (int)cudaErrorInvalidValue;
  const int nslabs = (g.e[0] + bd.slab - 1) / bd.slab;
  const int outer = fused ? g.nt[0] * g.nt[1] : tnt::num_tiles(g);
  const dim3 grid(outer * nslabs, (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  auto fn = fused ? spread_banded_kernel<true> : spread_banded_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, ip[tnt::kThreads], smem, (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const int*)zorigins, (const float*)values,
      (const float*)coords, (const float*)tw, (float*)out, g, k, bd);
  return (int)cudaGetLastError();
}

extern "C" const char* tnt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
