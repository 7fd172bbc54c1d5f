// Spread (type-1 step 1) for NVIDIA Hopper: slot-order point values ->
// per-tile halo-padded blocks [nt0 * nt1, B2, E0, E1] (float32, rank 2).
//
// Replaces two Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident_mats
//     (planned: precomputed kernel weights; here kPlanned = true), and
//   tensorflow_nufft_tpu/kernels/pallas_spread.py:_spread_kernel_resident
//     (unplanned: Horner or exp/sqrt evaluated in-kernel on the two-float
//     coordinates; here kPlanned = false).
//
// Design. One thread block per (tile, channel group) owns the tile's
// [group, E0, E1] halo block in dynamic shared memory (20.7 KB per channel
// at E = 72) and walks the tile's own chunks tile_bounds[t] ..
// tile_bounds[t+1]; the TPU kernels walked one global chunk stream, which
// has no counterpart when blocks run in parallel. Each chunk is staged in
// kSub-slot pieces: per slot the two axis windows (start + width weights,
// loaded from the planned artifact or evaluated here) and the group's
// values. Then every thread owns one (channel, e0) row of the block and
// adds, in slot order, the contribution w0 * (v * w1[j]) of each slot
// whose axis-0 window covers its row.
//
// Determinism: each output cell is written by exactly one thread, in slot
// order, with no atomics, so the result is bit-repeatable like the TPU
// kernel's. Shared-memory atomics (the cuFINUFFT SM method) would let all
// threads work on every slot; that is a later performance change.
//
// What bounds it on the H100: at the 2D headline (8 x 8 tiles) the grid
// has 64 blocks for 132 SMs, and within a block only the rows a slot's
// window covers (width of E0) do work on it, so the kernel is latency-
// and occupancy-bound, not bound by memory traffic (the planned artifact
// is ~6 MB, read once). The design keeps the traffic minimal (per-slot
// windows instead of the TPU path's dense, mostly-zero [E, chunk]
// matrices) and leaves the occupancy finding to a later PR.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;

constexpr int kSub = 128;  // slots staged at a time (kernels/spread.py)

template <bool kPlanned>
__global__ void spread_kernel(const int* __restrict__ tile_bounds,
                              const float* __restrict__ values,
                              const float* __restrict__ coords,
                              const float* __restrict__ weights,
                              const int* __restrict__ starts,
                              float* __restrict__ out, Geometry g,
                              EsKernel k) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int w = k.width;
  const int cells = g.e0 * g.e1;
  float* acc = smem;                      // [group][E0][E1]
  float* sw = acc + g.group * cells;      // [2][kSub][w] window weights
  float* sv = sw + 2 * kSub * w;          // [group][kSub] values
  int* ss = reinterpret_cast<int*>(sv + g.group * kSub);  // [2][kSub]

  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) acc[i] = 0.0f;
  const float origin0 = (float)((tile / g.nt1) * g.tile0 - g.pad);
  const float origin1 = (float)((tile % g.nt1) * g.tile1 - g.pad);
  const int kbeg = tile_bounds[tile];
  const int kend = tile_bounds[tile + 1];
  // The (channel, e0) row this thread owns.
  const int row = threadIdx.x;
  const bool owner = row < nc * g.e0;
  const int b = row / g.e0;
  const int e0 = row - b * g.e0;
  float* arow = acc + row * g.e1;

  for (int kc = kbeg; kc < kend; ++kc) {
    for (int off = 0; off < g.chunk; off += kSub) {
      const int n = min(kSub, g.chunk - off);
      const int base = kc * g.chunk + off;
      __syncthreads();  // the previous piece is consumed
      if (kPlanned) {
        const float* w0g = weights + (size_t)base * w;
        const float* w1g = weights + ((size_t)g.slots + base) * w;
        for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
          sw[i] = w0g[i];
          sw[kSub * w + i] = w1g[i];
        }
      }
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int slot = base + i;
        if (kPlanned) {
          ss[i] = starts[slot];
          ss[kSub + i] = starts[g.slots + slot];
        } else {
          ss[i] = tnt::es_window(coords[slot], coords[2 * g.slots + slot],
                                 origin0, k, sw + i * w);
          ss[kSub + i] = tnt::es_window(
              coords[g.slots + slot], coords[3 * g.slots + slot], origin1,
              k, sw + (kSub + i) * w);
        }
        for (int c = 0; c < nc; ++c)
          sv[c * kSub + i] = values[(size_t)(c0 + c) * g.slots + slot];
      }
      __syncthreads();
      if (owner) {
        for (int i = 0; i < n; ++i) {
          const int d0 = e0 - ss[i];
          if ((unsigned)d0 >= (unsigned)w) continue;
          const float w0 = sw[i * w + d0];
          const float v = sv[b * kSub + i];
          const int s1 = ss[kSub + i];
          const float* w1 = sw + (kSub + i) * w;
          for (int j = 0; j < w; ++j) {
            const int col = s1 + j;
            if ((unsigned)col < (unsigned)g.e1)
              arow[col] = __fadd_rn(arow[col],
                                    __fmul_rn(w0, __fmul_rn(v, w1[j])));
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = out + ((size_t)tile * g.batch2 + c0) * cells;
  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

// planned != 0: weights/starts are the planned artifact ([2, slots, w]
// float32 and [2, slots] int32) and coords is unused; planned == 0:
// coords is the [4, slots] payload (hi0, hi1, lo0, lo1). values is
// [B2, slots]; out is [nt0 * nt1, B2, E0, E1]. Returns the launch's CUDA
// error (0 on success).
extern "C" int tnt_spread(int planned, const void* tile_bounds,
                          const void* values, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const dim3 grid(g.nt0 * g.nt1, (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  void (*fn)(const int*, const float*, const float*, const float*,
             const int*, float*, Geometry, EsKernel) =
      planned ? spread_kernel<true> : spread_kernel<false>;
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
