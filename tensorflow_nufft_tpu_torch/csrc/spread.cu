// Spread (type-1 step 1) for NVIDIA Hopper: slot-order point values ->
// per-tile halo-padded blocks [num_tiles, B2, *ext] (float32, rank 2 or
// 3).
//
// Replaces six Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_mats
//   and :_spread_kernel_mats (the rank-3 per-tile grid): precomputed
//     kernel weights; here kPlanned = true;
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident
//   and :_spread_kernel (the rank-3 per-tile grid with its sub-chunk
//     fold): Horner or exp/sqrt evaluated in-kernel on the two-float
//     coordinates; here kPlanned = false;
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_split
//   and :_spread_kernel_split: the same with separate coords and values
//     payloads, which the TPU takes for channel groups wider than one
//     8-row combined payload (2 * rank + B2 > 8: the source and points
//     gradients of training); here kPlanned = false at any B2, the
//     channel groups on blockIdx.y, the last one partial.
// The TPU needs the per-tile-grid and split twins because VMEM cannot
// hold the whole tile array and a DMA moves 8-row blocks; on Hopper
// every block owns one tile at any rank and reads coords and values
// separately, so one kernel serves all six. Where the TPU plan cannot
// keep its dense matrices (the 3D headline) it runs
// :_spread_kernel_banded instead, whose tile blocks are the same; the
// planned kernel computes them on the unbanded geometry (the axis-0 band
// itself is not ported).
//
// Design. One thread block per (tile, channel group) owns the tile's
// [group, *ext] halo block in dynamic shared memory (20.7 KB per channel
// at 2D ext 72^2, 166 KB at 3D ext (24, 24, 72)) and walks the tile's own
// chunks tile_bounds[t] .. tile_bounds[t+1]; the TPU kernels walked one
// global chunk stream (or one grid step per tile in sequence), which has
// no counterpart when blocks run in parallel. Each chunk is staged in
// kSub-slot pieces: per slot the kRank axis windows (start + width
// weights, loaded from the planned artifact or evaluated here) and the
// group's values. Then every thread owns one row of the block along the
// last axis -- (channel, e0) at rank 2, (channel, e0, e1) at rank 3 --
// and adds, in slot order, the contribution wl * (v * wlast[j]) of each
// slot whose leading-axis windows cover its row, where wl is the product
// of the leading-axis weights (w0 at rank 2, w0 * w1 at rank 3: the
// Khatri-Rao factor of the TPU kernels' fold).
//
// Determinism: each output cell is written by exactly one thread, in slot
// order, with no atomics, so the result is bit-repeatable like the TPU
// kernel's. Shared-memory atomics (the cuFINUFFT SM method) would let all
// threads work on every slot; that is a later performance change.
//
// What bounds it on the H100: the kernel is latency- and occupancy-bound,
// not bound by memory traffic (the planned artifact is read once). At the
// 2D headline (8 x 8 tiles) the grid has 64 blocks for 132 SMs, and only
// the rows a slot's window covers do work on it: w of E0 rows at rank 2,
// w^2 = 49 of the 576 rows at 3D ext (24, 24, 72). At rank 3 the 179 KB
// block allows one block per SM. The design keeps the traffic minimal
// (per-slot windows instead of the TPU path's dense, mostly-zero
// [sum(E), chunk] matrices) and leaves occupancy to later work.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;

constexpr int kSub = 128;  // slots staged at a time (kernels/spread.py)

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

extern "C" const char* tnt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
