// The rank-2 and rank-3 interp kernel of csrc/interp.cu (its source
// note has the design) and its launch, shared by the two sources that
// instantiate it: interp.cu (ranks 2 and 3) and interp_banded.cu (the
// rank-3 binned level), compiled in parallel.
#pragma once

#include <utility>

#include "tnt_common.cuh"

namespace interp_rows {

using tnt::EsKernel;
using tnt::Geometry;

// Threads of an interp block at most, one per slot (kernels/interp.py).
constexpr int kMaxSlotThreads = 512;

// Copies n floats from global src to shared dst asynchronously, 16 bytes
// a thread-copy where `vec` (both 16-byte aligned, n a multiple of 4),
// else 4, and commits the group.
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

// The interp. Block (piece of run * sublen consecutive slots of one
// chunk, channel); thread t takes slot t of the piece (threads past it
// only help stage). out is [num_chunks, B2, chunk]. kStaged: shared
// memory holds two pieces of bd.slab axis-0 rows of the tile ([E1][E2]
// planes at rank 3, [E1] lines at rank 2), filled in turn by cp.async;
// else the block reads the tile array in place (a plane too large for
// two rows to fit a block). kBanded (rank 3, staged): the binned level,
// axis-0 windows counted from each sub-chunk's band origin, rows outside
// the band taking nothing. The window arrays have kW entries: the width
// itself for the rank-3 staged kernels (one per width, so the window
// loops unroll), a bound on it otherwise.
template <int kRank, int kW, bool kBanded, bool kStaged>
__global__ void __launch_bounds__(kMaxSlotThreads, 2)
    interp_rows_kernel(const int* __restrict__ tile_bounds,
                       const int* __restrict__ zorigins,
                       const float* __restrict__ tiles,
                       const float* __restrict__ coords,
                       const float* __restrict__ weights,
                       const int* __restrict__ starts,
                       float* __restrict__ out, Geometry g, EsKernel k,
                       tnt::Band bd) {
  constexpr bool kExact = kRank == 3 && kStaged;
  extern __shared__ float4 smem4[];
  float* f = reinterpret_cast<float*>(smem4);
  const int nt = tnt::num_tiles(g);
  const int per = bd.run * bd.sublen;  // the block's slots
  const int slot0 = blockIdx.x * per;
  const int kc = slot0 / g.chunk;
  if (kc >= tile_bounds[nt]) return;  // a chunk no tile owns (uniform)
  const int tile = tnt::owner_tile(tile_bounds, nt, kc);
  const int c = blockIdx.y;
  const int e0 = g.e[0], e1 = g.e[1];
  const int line = kRank == 3 ? g.e[2] : 1;
  const int plane = e1 * line;
  const int w = kExact ? kW : k.width;
  const int t = threadIdx.x;
  const bool mine = t < per;
  const int slot = slot0 + (mine ? t : 0);
  float origin[kRank];
  tnt::tile_origins<kRank>(g, tile, origin);
  float w0[kW], w1[kW], w2[kW];
  float* wd[3] = {w0, w1, w2};
  int s[3] = {0, 0, 0};
  int zo = 0, band = e0;  // unbanded: one band of all E0 rows
  if constexpr (kBanded) {
    zo = zorigins[slot / bd.sublen];
    band = bd.band;
    origin[0] = __fadd_rn(origin[0], (float)zo);
  }
#pragma unroll
  for (int d = 0; d < kRank; ++d) {
    // The coordinate's two words (coords is null where planned).
    const size_t hi = (size_t)d * g.slots + slot;
    const size_t lo = hi + (size_t)kRank * g.slots;
    if constexpr (kBanded) {
      s[d] = tnt::es_window_exact<kW>(coords[hi], coords[lo], origin[d], k,
                                      wd[d]);
    } else if (weights != nullptr) {
      s[d] = starts[(size_t)d * g.slots + slot];
      const float* src = weights + ((size_t)d * g.slots + slot) * w;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j < w) wd[d][j] = src[j];
    } else {
      s[d] = tnt::es_window<kW>(coords[hi], coords[lo], origin[d], k, wd[d],
                                d == k.deriv_axis);
    }
  }
  if (!mine) s[0] = -(1 << 30);  // no rows

  // Row i of the slot's window, from rows [p0, p0 + nrows) of the tile
  // at fb, where it lies there and in the band: rank 3 adds (w0[i]
  // w1[j]) (sum_x w2[x] F[.., s1 + j, s2 + x]) for each j, rank 2 w0[i]
  // (sum_j w1[j] F[.., s1 + j]).
  float acc = 0.0f;
  auto row = [&](const float* fb, int p0, int nrows, int i) {
    const int q = s[0] + i;     // the row in the band's coordinates
    const int r = zo + q - p0;  // the row at fb
    if ((unsigned)q >= (unsigned)band || (unsigned)r >= (unsigned)nrows)
      return;
    if constexpr (kRank == 3) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const int r1 = s[1] + j;
        if (j >= w || (unsigned)r1 >= (unsigned)e1) continue;
        const float* frow = fb + (r * e1 + r1) * line;
        float inner = 0.0f;
#pragma unroll
        for (int x = 0; x < kW; ++x) {
          const int col = s[2] + x;
          if (x < w && (unsigned)col < (unsigned)line)
            inner = __fadd_rn(inner, __fmul_rn(frow[col], w2[x]));
        }
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w0[i], w1[j]), inner));
      }
    } else {
      const float* frow = fb + r * e1;
      float inner = 0.0f;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const int col = s[1] + j;
        if (j < w && (unsigned)col < (unsigned)e1)
          inner = __fadd_rn(inner, __fmul_rn(frow[col], w1[j]));
      }
      acc = __fadd_rn(acc, __fmul_rn(w0[i], inner));
    }
  };
  // The rows in ascending order: all kW^3 terms unrolled up to width 8;
  // wider windows keep the row loop rolled (kW^2 unrolled terms), which
  // bounds the code the widths compile to.
  auto rows = [&](const float* fb, int p0, int nrows) {
    if constexpr (kW <= 8) {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        if (i < w) row(fb, p0, nrows, i);
    } else {
#pragma unroll 1
      for (int i = 0; i < w; ++i) row(fb, p0, nrows, i);
    }
  };

  const float* src = tiles + ((size_t)tile * g.batch2 + c) * e0 * plane;
  if constexpr (kStaged) {
    // The rows [first, last) the block's windows touch: banded, the union
    // of its sub-chunks' bands (those that hold a point); else the span
    // of its slots' axis-0 windows.
    int first = e0, last = 0;
    if constexpr (kBanded) {
      const int sc0 = slot0 / bd.sublen;
      for (int j = 0; j < bd.run; ++j) {
        const int sc = sc0 + j;
        if (coords[(size_t)sc * bd.sublen] != tnt::kSentinel) {
          const int z = zorigins[sc];
          first = min(first, z);
          last = max(last, z + bd.band);
        }
      }
    } else {
      __shared__ int span[2][kMaxSlotThreads / 32];
      const bool in = s[0] + w > 0 && s[0] < e0;
      const int lo = __reduce_min_sync(0xffffffffu, in ? max(s[0], 0) : e0);
      const int hi = __reduce_max_sync(0xffffffffu,
                                       in ? min(s[0] + w, e0) : 0);
      if ((t & 31) == 0) {
        span[0][t >> 5] = lo;
        span[1][t >> 5] = hi;
      }
      __syncthreads();
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        first = min(first, span[0][i]);
        last = max(last, span[1][i]);
      }
    }
    // Pieces of bd.slab rows, double-buffered: for one channel a piece is
    // one contiguous range of the tile array, copied while the block
    // contracts the piece before it. The pieces ascend, so each slot sums
    // its rows in increasing order, as in one pass.
    const bool vec = plane % 4 == 0 &&
                     reinterpret_cast<size_t>(tiles) % 16 == 0;
    const int pieces = last > first ? (last - first + bd.slab - 1) / bd.slab
                                    : 0;
    if (pieces > 0)
      copy_async(f, src + (size_t)first * plane,
                 min(bd.slab, last - first) * plane, vec);
    for (int p = 0; p < pieces; ++p) {
      const int p0 = first + p * bd.slab;  // the piece's first row
      if (p + 1 < pieces) {
        const int p1 = p0 + bd.slab;
        copy_async(f + (size_t)((p + 1) & 1) * bd.slab * plane,
                   src + (size_t)p1 * plane,
                   min(bd.slab, last - p1) * plane, vec);
        wait_async<1>();
      } else {
        wait_async<0>();
      }
      __syncthreads();  // piece p is in shared memory
      rows(f + (size_t)(p & 1) * bd.slab * plane, p0,
           min(bd.slab, last - p0));
      __syncthreads();  // piece p is consumed before p + 2 lands there
    }
  } else {
    rows(src, 0, e0);
  }
  if (mine)
    out[((size_t)kc * g.batch2 + c) * g.chunk + (slot0 - kc * g.chunk) + t] =
        acc;
}

using InterpFn = void (*)(const int*, const int*, const float*,
                          const float*, const float*, const int*, float*,
                          Geometry, EsKernel, tnt::Band);

template <bool kBanded, int... kWs>
InterpFn exact_fn(int width, std::integer_sequence<int, kWs...>) {
  InterpFn fn = nullptr;
  ((fn = width == kWs ? interp_rows_kernel<3, kWs, kBanded, true> : fn),
   ...);
  return fn;
}

// Launches fn on grid (slots / (run * sublen), channels) after checking
// the layout it takes; returns the CUDA error.
inline cudaError_t launch(InterpFn fn, const int* tile_bounds,
                          const int* zorigins, const float* tiles,
                          const float* coords, const float* weights,
                          const int* starts, float* out, const Geometry& g,
                          const EsKernel& k, const tnt::Band& bd,
                          const int* ip, cudaStream_t s) {
  const int per = bd.run * bd.sublen;
  const int threads = ip[tnt::kThreads];
  if (fn == nullptr || per < 1 || g.chunk % per || bd.slab < 0 ||
      threads != (per + 31) / 32 * 32 || threads > kMaxSlotThreads ||
      g.group != 1)
    return cudaErrorInvalidValue;
  const dim3 grid(g.slots / per, g.batch2);
  const int smem = ip[tnt::kSmem];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, threads, smem, s>>>(tile_bounds, zorigins, tiles, coords,
                                 weights, starts, out, g, k, bd);
  return cudaGetLastError();
}

// The rank-3 staged kernels, one per width 2 .. kMaxWidth
// (plan.MAX_KERNEL_WIDTH).
template <bool kBanded>
InterpFn rank3_fn(int width) {
  return exact_fn<kBanded>(
      width, std::integer_sequence<int, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                   13, 14, 15, 16>{});
}

}  // namespace interp_rows
