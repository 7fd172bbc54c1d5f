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
// Design (banded). A block serves a run of consecutive sub-chunks of one
// chunk (a whole chunk of 512 slots at the 3D headline) for one channel,
// one thread per slot. It stages the union of the run's bands [zorigins[j],
// + band) -- z-ordered binning keeps a chunk's bands close, about 24 rows
// for 512 slots at the headline against 16 for each 128-slot sub-chunk --
// in pieces of kSlab rows, double-buffered: for one channel a piece's rows
// are one contiguous range of the tile array, copied with 16-byte
// cp.async (4-byte where rows do not align) while the block contracts the
// piece before it. Two buffers of 8 rows (110.6 KB at ext (136, 24, 72))
// let two blocks share an SM. Each thread forms its windows with
// es_window_exact (axis 0 counted from its sub-chunk's band origin) into
// registers -- the kernel is instantiated per width, so the window loops
// unroll -- and contracts, in the order above, the window rows that lie
// in the piece and in its own band, rows outside the band taking nothing.
// The pieces ascend, so each slot's rows are summed in increasing order
// as in one pass: each slot has one owner and a fixed order, and the
// result is bit-repeatable (and equal to the sub-chunk-per-block kernel
// this design replaced). Sub-chunks of padded slots are left out of the
// union; blocks of chunks past tile_bounds[-1] exit at once.
//
// What bounds it on the H100: width^rank shared-memory reads per slot and
// channel (49 at 2D, 343 at 3D, width 7) at scattered addresses, plus,
// unplanned, rank * width kernel evaluations per slot; global traffic is
// small (the tile blocks once, the planned windows, the output). The
// unbanded design keeps the last axis's window in registers and the
// block's data in shared memory; at rank 3 the leading windows are
// indexed in loops that are not unrolled (16^3 unrolled steps would not
// fit), which puts them in local memory, cached in L1. The banded
// kernel's predecessor staged 221 KB of band rows for every 128 slots
// (1.5 GB at the 3D headline, 4 bytes a load, one block of 8 warps per
// SM, no overlap of copy and contraction: 3.97 ms against a 0.08 ms byte
// bound on an H100); staging a chunk's union once, in 16-byte
// asynchronous copies that overlap the contraction, moves about a third
// of that, and the per-width instantiation keeps the 343-term
// contraction in registers and shared memory (PERF.md has the card
// times).
#include <utility>

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

// Copies n floats from global src to shared dst asynchronously, 16 bytes
// a thread-copy where `vec` (both 16-byte aligned, n a multiple of 4),
// else 4; the caller commits the group.
__device__ __forceinline__ void copy_async(float* dst,
                                           const float* __restrict__ src,
                                           int n, bool vec) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 4 * i),
                   "l"(src + i));
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       base + 4 * i),
                   "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rank-3 banded interp at width kW. Block (run of bd.run sub-chunks,
// channel); thread t takes slot t of the run. out is [num_chunks, B2,
// chunk]; shared memory holds two pieces of bd.slab rows [E1][E2].
template <int kW>
__global__ void __launch_bounds__(512, 2)
    interp_banded_kernel(const int* __restrict__ tile_bounds,
                         const int* __restrict__ zorigins,
                         const float* __restrict__ tiles,
                         const float* __restrict__ coords,
                         float* __restrict__ out, Geometry g, EsKernel k,
                         tnt::Band bd) {
  extern __shared__ float4 smem4[];
  float* f = reinterpret_cast<float*>(smem4);
  const int nt = tnt::num_tiles(g);
  const int subs = g.chunk / bd.sublen;
  const int sc0 = blockIdx.x * bd.run;  // first sub-chunk of the run
  const int kc = sc0 / subs;
  if (kc >= tile_bounds[nt]) return;  // a chunk no tile owns (uniform)
  int lo = 0, hi = nt - 1;            // the tile owning chunk kc
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_bounds[mid] <= kc) lo = mid; else hi = mid - 1;
  }
  const int tile = lo;
  const int c = blockIdx.y;
  const int e0 = g.e[0], e1 = g.e[1], e2 = g.e[2];
  const int plane = e1 * e2;
  // The union [first, last) of the bands of the run's sub-chunks that
  // hold a point.
  int first = e0, last = 0;
  for (int j = 0; j < bd.run; ++j) {
    const int sc = sc0 + j;
    if (coords[(size_t)sc * bd.sublen] != tnt::kSentinel) {
      const int zo = zorigins[sc];
      first = min(first, zo);
      last = max(last, zo + bd.band);
    }
  }
  const int t = threadIdx.x;
  const int sc = sc0 + t / bd.sublen;
  const int slot = sc0 * bd.sublen + t;
  const int zo = zorigins[sc];
  float origin[3];
  tnt::tile_origins<3>(g, tile, origin);
  float w0[kW], w1[kW], w2[kW];
  const int s0 = tnt::es_window_exact<kW>(
      coords[slot], coords[(size_t)3 * g.slots + slot],
      __fadd_rn(origin[0], (float)zo), k, w0);
  const int s1 = tnt::es_window_exact<kW>(
      coords[(size_t)g.slots + slot], coords[(size_t)4 * g.slots + slot],
      origin[1], k, w1);
  const int s2 = tnt::es_window_exact<kW>(
      coords[(size_t)2 * g.slots + slot],
      coords[(size_t)5 * g.slots + slot], origin[2], k, w2);

  const float* src = tiles + ((size_t)tile * g.batch2 + c) * e0 * plane;
  const bool vec = plane % 4 == 0 &&
                   reinterpret_cast<size_t>(tiles) % 16 == 0;
  const int pieces = last > first ? (last - first + bd.slab - 1) / bd.slab
                                  : 0;
  if (pieces > 0)
    copy_async(f, src + (size_t)first * plane,
               min(bd.slab, last - first) * plane, vec);
  float acc = 0.0f;
  for (int p = 0; p < pieces; ++p) {
    const int p0 = first + p * bd.slab;  // the piece's first row
    const int nrows = min(bd.slab, last - p0);
    if (p + 1 < pieces) {
      const int p1 = p0 + bd.slab;
      copy_async(f + (size_t)((p + 1) & 1) * bd.slab * plane,
                 src + (size_t)p1 * plane, min(bd.slab, last - p1) * plane,
                 vec);
      wait_async<1>();
    } else {
      wait_async<0>();
    }
    __syncthreads();  // piece p is in shared memory
    const float* fb = f + (size_t)(p & 1) * bd.slab * plane;
    // Row i of the slot's window, where it lies in this piece and in the
    // band: acc += (w0[i] w1[j]) (sum_x w2[x] F[.., s1 + j, s2 + x]).
    auto row = [&](int i, float wi) {
      const int q = s0 + i;       // the row in the band's coordinates
      const int r = zo + q - p0;  // the row in this piece
      if ((unsigned)q >= (unsigned)bd.band || (unsigned)r >= (unsigned)nrows)
        return;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const int r1 = s1 + j;
        if ((unsigned)r1 >= (unsigned)e1) continue;
        const float* frow = fb + (r * e1 + r1) * e2;
        float inner = 0.0f;
#pragma unroll
        for (int x = 0; x < kW; ++x) {
          const int col = s2 + x;
          if ((unsigned)col < (unsigned)e2)
            inner = __fadd_rn(inner, __fmul_rn(frow[col], w2[x]));
        }
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wi, w1[j]), inner));
      }
    };
    // All kW^3 terms unrolled up to width 8; wider windows keep the
    // row loop rolled (kW^2 unrolled terms), which bounds the code the
    // fifteen widths compile to.
    if constexpr (kW <= 8) {
#pragma unroll
      for (int i = 0; i < kW; ++i) row(i, w0[i]);
    } else {
#pragma unroll 1
      for (int i = 0; i < kW; ++i) row(i, w0[i]);
    }
    __syncthreads();  // piece p is consumed before p + 2 lands there
  }
  out[((size_t)kc * g.batch2 + c) * g.chunk + (sc0 - kc * subs) * bd.sublen +
      t] = acc;
}

using BandedFn = void (*)(const int*, const int*, const float*,
                          const float*, float*, Geometry, EsKernel,
                          tnt::Band);

template <int... kWs>
BandedFn banded_fn(int width, std::integer_sequence<int, kWs...>) {
  BandedFn fn = nullptr;
  ((fn = width == kWs ? interp_banded_kernel<kWs> : fn), ...);
  return fn;
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
// chunks the tiles own are written). One channel per block (group 1).
// Returns the launch's CUDA error.
extern "C" int tnt_interp_banded(const void* tile_bounds,
                                 const void* zorigins, const void* tiles,
                                 const void* coords, void* out,
                                 const int* ip, const float* fp,
                                 void* stream) {
  const Geometry g = tnt::geometry_from(ip);
  const EsKernel k = tnt::es_from(ip, fp);
  const tnt::Band bd = tnt::band_from(ip);
  const int threads = ip[tnt::kThreads];
  if (g.rank != 3 || bd.slab < 1 || bd.sublen < 1 || bd.run < 1 ||
      g.chunk % (bd.sublen * bd.run) || bd.band > g.e[0] || g.group != 1 ||
      threads != bd.run * bd.sublen || threads > 512)
    return (int)cudaErrorInvalidValue;
  // Widths 2 .. kMaxWidth (plan.MAX_KERNEL_WIDTH).
  const BandedFn fn = banded_fn(
      k.width, std::integer_sequence<int, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                     13, 14, 15, 16>{});
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(g.slots / (bd.sublen * bd.run), g.batch2);
  const int smem = ip[tnt::kSmem];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tile_bounds, (const int*)zorigins, (const float*)tiles,
      (const float*)coords, (float*)out, g, k, bd);
  return (int)cudaGetLastError();
}
