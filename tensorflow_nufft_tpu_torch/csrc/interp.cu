// Interp (type-2 step 3) for NVIDIA Hopper: per-tile halo-padded blocks
// [nt0 * nt1, B2, E0, E1] -> slot-order values [num_chunks, B2, chunk]
// (float32, rank 2).
//
// Replaces two Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel_resident_mats
//     (planned: precomputed kernel weights; here kPlanned = true), and
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel
//     (unplanned: in-kernel Horner or exp/sqrt on the two-float
//     coordinates; here kPlanned = false; its deriv_axis variant is not
//     ported yet).
//
// Design. One thread block per (tile, channel group) stages the tile's
// [group, E0, E1] block in dynamic shared memory, then one thread per slot
// of the tile's chunks tile_bounds[t] .. tile_bounds[t+1] forms its two
// axis windows (from the planned artifact or evaluated here, kept in
// registers) and computes, per channel,
//     c = sum_i w0[i] * (sum_j w1[j] * F[s0 + i, s1 + j]),
// the order of the TPU kernel's two contractions. Padded slots have their
// window out of range and give exactly 0. Chunks past tile_bounds[-1]
// belong to no block and are never read or written.
//
// What bounds it on the H100: width^2 shared-memory reads per slot and
// channel (49 at width 7) at scattered addresses, plus, unplanned, 2 *
// width Horner evaluations per slot; global traffic is small (the tile
// blocks once, ~6 MB of planned windows, the output). At the 2D headline
// the grid has 64 blocks per channel group for 132 SMs. The design keeps
// the windows in registers and the block's data in shared memory; filling
// the card is left to a later PR.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;
using tnt::kMaxWidth;

template <bool kPlanned>
__global__ void interp_kernel(const int* __restrict__ tile_bounds,
                              const float* __restrict__ tiles,
                              const float* __restrict__ coords,
                              const float* __restrict__ weights,
                              const int* __restrict__ starts,
                              float* __restrict__ out, Geometry g,
                              EsKernel k) {
  extern __shared__ float f[];  // [group][E0][E1]
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int w = k.width;
  const int cells = g.e0 * g.e1;

  const float* src = tiles + ((size_t)tile * g.batch2 + c0) * cells;
  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) f[i] = src[i];
  __syncthreads();

  const float origin0 = (float)((tile / g.nt1) * g.tile0 - g.pad);
  const float origin1 = (float)((tile % g.nt1) * g.tile1 - g.pad);
  const int kbeg = tile_bounds[tile];
  const int kend = tile_bounds[tile + 1];
  for (int kc = kbeg; kc < kend; ++kc) {
    for (int c = threadIdx.x; c < g.chunk; c += blockDim.x) {
      const int slot = kc * g.chunk + c;
      float w0[kMaxWidth], w1[kMaxWidth];
      int s0, s1;
      if (kPlanned) {
        s0 = starts[slot];
        s1 = starts[g.slots + slot];
        const float* w0g = weights + (size_t)slot * w;
        const float* w1g = weights + ((size_t)g.slots + slot) * w;
#pragma unroll
        for (int j = 0; j < kMaxWidth; ++j) {
          if (j < w) {
            w0[j] = w0g[j];
            w1[j] = w1g[j];
          }
        }
      } else {
        s0 = tnt::es_window(coords[slot], coords[2 * g.slots + slot],
                            origin0, k, w0);
        s1 = tnt::es_window(coords[g.slots + slot],
                            coords[3 * g.slots + slot], origin1, k, w1);
      }
      for (int b = 0; b < nc; ++b) {
        const float* fb = f + b * cells;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxWidth; ++i) {
          const int r = s0 + i;
          if (i < w && (unsigned)r < (unsigned)g.e0) {
            float inner = 0.0f;
#pragma unroll
            for (int j = 0; j < kMaxWidth; ++j) {
              const int col = s1 + j;
              if (j < w && (unsigned)col < (unsigned)g.e1)
                inner = __fadd_rn(inner,
                                  __fmul_rn(fb[r * g.e1 + col], w1[j]));
            }
            acc = __fadd_rn(acc, __fmul_rn(w0[i], inner));
          }
        }
        out[((size_t)kc * g.batch2 + c0 + b) * g.chunk + c] = acc;
      }
    }
  }
}

}  // namespace

// planned != 0: weights/starts are the planned artifact and coords is
// unused; planned == 0: coords is the [4, slots] payload. tiles is
// [nt0 * nt1, B2, E0, E1]; out is [num_chunks, B2, chunk] (only the
// chunks the tiles own are written). Returns the launch's CUDA error.
extern "C" int tnt_interp(int planned, const void* tile_bounds,
                          const void* tiles, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const dim3 grid(g.nt0 * g.nt1, (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  void (*fn)(const int*, const float*, const float*, const float*,
             const int*, float*, Geometry, EsKernel) =
      planned ? interp_kernel<true> : interp_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, ip[tnt::kThreads], smem, (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const float*)tiles, (const float*)coords,
      (const float*)weights, (const int*)starts, (float*)out, g, k);
  return (int)cudaGetLastError();
}
