// Interp (type-2 step 3) for NVIDIA Hopper: per-tile halo-padded blocks
// [num_tiles, B2, *ext] -> slot-order values [num_chunks, B2, chunk]
// (float32, rank 2 or 3).
//
// Replaces four Pallas TPU kernels:
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel_resident_mats
//   and :_interp_kernel_mats (the rank-3 per-tile grid): precomputed
//     kernel weights; here kPlanned = true;
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel
//     (unplanned, ranks 2 and 3: in-kernel Horner or exp/sqrt on the
//     two-float coordinates; here kPlanned = false). Its deriv_axis flag,
//     the backward kernel of the spread-only ops, is the runtime
//     EsKernel::deriv_axis: that axis's window holds phi' (direct
//     exp/sqrt, es_eval_deriv) and the other axes keep phi. Planned
//     windows never carry phi', as in the TPU path.
//   tensorflow_nufft_tpu/kernels/pallas_interp.py:_interp_kernel_banded
//     (the planned rank-3 binned level: z-ordered binning on a coarse
//     axis-0 geometry, sub-chunk j reading only the axis-0 rows
//     [zorigins[j], + band)); here interp_banded_kernel.
//
// Design. One thread block per (tile, channel group) stages the tile's
// [group, *ext] block in dynamic shared memory (166 KB per channel at 3D
// ext (24, 24, 72), so the group is 1 there), then one thread per slot of
// the tile's chunks tile_bounds[t] .. tile_bounds[t+1] forms its kRank
// axis windows (from the planned artifact or evaluated here) and
// computes, per channel,
//     rank 2: c = sum_i w0[i] * (sum_j w1[j] * F[s0 + i, s1 + j])
//     rank 3: c = sum_{i,j} (w0[i] * w1[j]) * (sum_k w2[k] * F[..]),
// the order of the TPU kernels' contractions (the last axis first, then
// the Khatri-Rao-folded leading axes). Padded slots have their window out
// of range and give exactly 0. Chunks past tile_bounds[-1] belong to no
// block and are never read or written.
//
// Design (banded). One thread block per (sub-chunk, channel group) --
// blocks run in parallel and each slot has one owner, so no tile-level
// ownership is needed -- stages only the band rows [zo, zo + band) of its
// tile's block in shared memory (16 x 24 x 72 x 4 B = 110.6 KB per
// channel at the 3D headline, against 939 KB for the whole block), kSlab
// rows at a time where a band does not fit, and one thread per (channel,
// slot) contracts in the order above, its windows from es_window_exact
// (axis 0's counted from the band origin), rows outside the band taking
// nothing. Sub-chunks of chunks past
// tile_bounds[-1] exit at once.
//
// What bounds it on the H100: width^rank shared-memory reads per slot and
// channel (49 at 2D, 343 at 3D, width 7) at scattered addresses, plus,
// unplanned, rank * width kernel evaluations per slot; global traffic is
// small (the tile blocks once, the planned windows, the output). The
// design keeps the last axis's window in registers and the block's data
// in shared memory; at rank 3 the leading windows are indexed in loops
// that are not unrolled (16^3 unrolled steps would not fit), which puts
// them in local memory, cached in L1. Filling the card is left to later
// work.
#include "tnt_common.cuh"

namespace {

using tnt::EsKernel;
using tnt::Geometry;
using tnt::kMaxWidth;

template <int kRank, bool kPlanned>
__global__ void interp_kernel(const int* __restrict__ tile_bounds,
                              const float* __restrict__ tiles,
                              const float* __restrict__ coords,
                              const float* __restrict__ weights,
                              const int* __restrict__ starts,
                              float* __restrict__ out, Geometry g,
                              EsKernel k) {
  extern __shared__ float f[];  // [group][*ext]
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int w = k.width;
  int cells = 1;
#pragma unroll
  for (int d = 0; d < kRank; ++d) cells *= g.e[d];

  const float* src = tiles + ((size_t)tile * g.batch2 + c0) * cells;
  for (int i = threadIdx.x; i < nc * cells; i += blockDim.x) f[i] = src[i];
  __syncthreads();

  float origin[kRank];
  tnt::tile_origins<kRank>(g, tile, origin);
  const int kbeg = tile_bounds[tile];
  const int kend = tile_bounds[tile + 1];
  for (int kc = kbeg; kc < kend; ++kc) {
    for (int c = threadIdx.x; c < g.chunk; c += blockDim.x) {
      const int slot = kc * g.chunk + c;
      float w0[kMaxWidth], w1[kMaxWidth], w2[kMaxWidth];
      float* wt[3] = {w0, w1, w2};
      int s[kRank];
#pragma unroll
      for (int d = 0; d < kRank; ++d) {
        if (kPlanned) {
          s[d] = starts[(size_t)d * g.slots + slot];
          const float* wg = weights + ((size_t)d * g.slots + slot) * w;
#pragma unroll
          for (int j = 0; j < kMaxWidth; ++j) {
            if (j < w) wt[d][j] = wg[j];
          }
        } else {
          s[d] = tnt::es_window(coords[(size_t)d * g.slots + slot],
                                coords[(size_t)(kRank + d) * g.slots + slot],
                                origin[d], k, wt[d], d == k.deriv_axis);
        }
      }
      for (int b = 0; b < nc; ++b) {
        const float* fb = f + b * cells;
        float acc = 0.0f;
        if (kRank == 2) {
#pragma unroll
          for (int i = 0; i < kMaxWidth; ++i) {
            const int r = s[0] + i;
            if (i < w && (unsigned)r < (unsigned)g.e[0]) {
              float inner = 0.0f;
#pragma unroll
              for (int j = 0; j < kMaxWidth; ++j) {
                const int col = s[kRank - 1] + j;
                if (j < w && (unsigned)col < (unsigned)g.e[1])
                  inner = __fadd_rn(inner,
                                    __fmul_rn(fb[r * g.e[1] + col], w1[j]));
              }
              acc = __fadd_rn(acc, __fmul_rn(w0[i], inner));
            }
          }
        } else {
#pragma unroll 1
          for (int i = 0; i < w; ++i) {
            const int r0 = s[0] + i;
            if ((unsigned)r0 >= (unsigned)g.e[0]) continue;
#pragma unroll 1
            for (int j = 0; j < w; ++j) {
              const int r1 = s[1] + j;
              if ((unsigned)r1 >= (unsigned)g.e[1]) continue;
              const float* frow = fb + (r0 * g.e[1] + r1) * g.e[2];
              float inner = 0.0f;
#pragma unroll
              for (int q = 0; q < kMaxWidth; ++q) {
                const int col = s[kRank - 1] + q;
                if (q < w && (unsigned)col < (unsigned)g.e[2])
                  inner = __fadd_rn(inner, __fmul_rn(frow[col], w2[q]));
              }
              acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w0[i], w1[j]),
                                             inner));
            }
          }
        }
        out[((size_t)kc * g.batch2 + c0 + b) * g.chunk + c] = acc;
      }
    }
  }
}

// Rank-3 banded interp. Block (sub-chunk, channel group); threads
// (channel, slot) of the sub-chunk. out is [num_chunks, B2, chunk].
__global__ void interp_banded_kernel(const int* __restrict__ tile_bounds,
                                     const int* __restrict__ zorigins,
                                     const float* __restrict__ tiles,
                                     const float* __restrict__ coords,
                                     float* __restrict__ out, Geometry g,
                                     EsKernel k, tnt::Band bd) {
  extern __shared__ float f[];  // [group][slab rows][E1][E2]
  const int nt = tnt::num_tiles(g);
  const int subs = g.chunk / bd.sublen;
  const int sc = blockIdx.x;
  const int kc = sc / subs;
  if (kc >= tile_bounds[nt]) return;  // a chunk no tile owns (uniform)
  int lo = 0, hi = nt - 1;            // the tile owning chunk kc
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_bounds[mid] <= kc) lo = mid; else hi = mid - 1;
  }
  const int tile = lo;
  const int zo = zorigins[sc];
  const int c0 = blockIdx.y * g.group;
  const int nc = min(g.group, g.batch2 - c0);
  const int w = k.width;
  const int e1 = g.e[1], e2 = g.e[2];
  const int plane = e1 * e2;
  const int b = threadIdx.x / bd.sublen;
  const int c = threadIdx.x - b * bd.sublen;
  const bool active = b < nc;
  const int slot = kc * g.chunk + (sc - kc * subs) * bd.sublen + c;

  float w0[kMaxWidth], w1[kMaxWidth], w2[kMaxWidth];
  int s0 = 0, s1 = 0, s2 = 0;
  if (active) {
    float origin[3];
    tnt::tile_origins<3>(g, tile, origin);
    s0 = tnt::es_window_exact(coords[slot],
                              coords[(size_t)3 * g.slots + slot],
                              __fadd_rn(origin[0], (float)zo), k, w0);
    s1 = tnt::es_window_exact(coords[(size_t)g.slots + slot],
                              coords[(size_t)4 * g.slots + slot], origin[1],
                              k, w1);
    s2 = tnt::es_window_exact(coords[(size_t)2 * g.slots + slot],
                              coords[(size_t)5 * g.slots + slot], origin[2],
                              k, w2);
  }
  float acc = 0.0f;
  // The band's rows in pieces of kSlab (the whole band at the headline),
  // each staged for the group, contracted in increasing row order.
  for (int q = 0; q < bd.band; q += bd.slab) {
    const int nrows = min(bd.slab, bd.band - q);
    __syncthreads();  // the previous piece is consumed
    for (int b2 = 0; b2 < nc; ++b2) {
      const float* src =
          tiles + (((size_t)tile * g.batch2 + c0 + b2) * g.e[0] + zo + q) *
                      plane;
      float* dst = f + (size_t)b2 * bd.slab * plane;
      for (int i = threadIdx.x; i < nrows * plane; i += blockDim.x)
        dst[i] = src[i];
    }
    __syncthreads();
    if (!active) continue;
    const float* fb = f + (size_t)b * bd.slab * plane;
#pragma unroll 1
    for (int i = 0; i < w; ++i) {
      const int r0 = s0 + i - q;  // row within this piece
      if ((unsigned)r0 >= (unsigned)nrows) continue;
#pragma unroll 1
      for (int j = 0; j < w; ++j) {
        const int r1 = s1 + j;
        if ((unsigned)r1 >= (unsigned)e1) continue;
        const float* frow = fb + (r0 * e1 + r1) * e2;
        float inner = 0.0f;
#pragma unroll
        for (int p = 0; p < kMaxWidth; ++p) {
          const int col = s2 + p;
          if (p < w && (unsigned)col < (unsigned)e2)
            inner = __fadd_rn(inner, __fmul_rn(frow[col], w2[p]));
        }
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w0[i], w1[j]), inner));
      }
    }
  }
  if (active)
    out[((size_t)kc * g.batch2 + c0 + b) * g.chunk +
        (sc - kc * subs) * bd.sublen + c] = acc;
}

using InterpFn = void (*)(const int*, const float*, const float*,
                          const float*, const int*, float*, Geometry,
                          EsKernel);

InterpFn interp_fn(int rank, bool planned) {
  if (rank == 2) return planned ? interp_kernel<2, true>
                                : interp_kernel<2, false>;
  return planned ? interp_kernel<3, true> : interp_kernel<3, false>;
}

}  // namespace

// planned != 0: weights/starts are the planned artifact and coords is
// unused; planned == 0: coords is the [2 * rank, slots] payload. tiles is
// [num_tiles, B2, *ext]; out is [num_chunks, B2, chunk] (only the chunks
// the tiles own are written). Returns the launch's CUDA error.
extern "C" int tnt_interp(int planned, const void* tile_bounds,
                          const void* tiles, const void* coords,
                          const void* weights, const void* starts,
                          void* out, const int* ip, const float* fp,
                          void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  if (g.rank != 2 && g.rank != 3) return (int)cudaErrorInvalidValue;
  const dim3 grid(tnt::num_tiles(g), (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  const InterpFn fn = interp_fn(g.rank, planned != 0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, ip[tnt::kThreads], smem, (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const float*)tiles, (const float*)coords,
      (const float*)weights, (const int*)starts, (float*)out, g, k);
  return (int)cudaGetLastError();
}

// Rank-3 banded interp: tiles [num_tiles, B2, *ext], coords [6, slots],
// zorigins [num_chunks * subs]; out [num_chunks, B2, chunk] (only the
// chunks the tiles own are written). Returns the launch's CUDA error.
extern "C" int tnt_interp_banded(const void* tile_bounds,
                                 const void* zorigins, const void* tiles,
                                 const void* coords, void* out,
                                 const int* ip, const float* fp,
                                 void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  if (g.rank != 3 || bd.slab < 1 || bd.sublen < 1 || g.chunk % bd.sublen ||
      bd.band > g.e[0])
    return (int)cudaErrorInvalidValue;
  const int subs = g.chunk / bd.sublen;
  const dim3 grid(g.slots / g.chunk * subs,
                  (g.batch2 + g.group - 1) / g.group);
  const int smem = ip[tnt::kSmem];
  cudaError_t err = cudaFuncSetAttribute(
      interp_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  interp_banded_kernel<<<grid, ip[tnt::kThreads], smem,
                         (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const int*)zorigins, (const float*)tiles,
      (const float*)coords, (float*)out, g, k, bd);
  return (int)cudaGetLastError();
}
