// Rank-3 mode stages for NVIDIA Hopper: the halo kernels around the
// pruned FFT passes (csrc/fft3d.cu) of the 3D planar NUFFT.
//
// Type-1 post-stage, replacing the halo fold of the Pallas TPU kernels
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_pass_a_kernel,
//   :_pass_b_kernel and :_pass_c_kernel
// (the periodic overlap-add of the tile halos, the DFT, truncation to the
// n modes and deconvolution, one axis per pass as matrix products):
//   fold3d               tiles [*tiles, 2B, *ext] f32 -> complex64 fine
//                        grid [B, *nf] (re/im interleaved, the FFT's input)
//   (fft_axis over the three axes, the truncation and deconvolution in
//   its last store: csrc/fft3d.cu)
// Type-2 pre-stage, replacing the halo windows of
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_dual_c_kernel,
//   :_dual_b_kernel and :_dual_a_kernel
// (amplification, zero-padding, the DFT and halo windowing):
//   (fft_axis over the three axes, the amplification and padding in its
//   first load: csrc/fft3d.cu)
//   extend_tiles3d       complex64 fine grid -> [*tiles, 2B, *ext] f32
//                        with periodic halos
// The TPU computes the DFT as matrix products with the fold, padding and
// weights built in; here the DFT with the mode ends is csrc/fft3d.cu, and
// the halo steps of those six kernels are here.
//
// Two-axis variant (kAxes = 2), after the fused banded spread
// (csrc/spread.cu, replacing pallas_spread.py:
// _spread_kernel_split_banded_dfta, whose epilogue already contracted
// axis 2 to its n2 modes with the deconvolving twiddles), replacing the
// fold of pallas_dft.py:_pass_b_kernel and :_pass_c_kernel on that route
// (_run_passes_bc):
//   fold3d               y [nt0, nt1, 2B, E0, E1, n2] -> complex64
//                        [B, nf0, nf1, n2]: the overlap-add of axes 0 and
//                        1 only (axis 2 is one untiled block of n2)
//   (fft_axis over axes 1 and 0, csrc/fft3d.cu)
//
// Design of the halo kernels, extend_tiles3d and fold3d (and fold3d with
// kAxes = 2). Both move memory and do at most 8 additions a cell, so
// what bounds them on the H100 is bytes: at the 3D headline (fine 256^3,
// 1024 tiles of ext (24, 24, 72), batch 1) the 340 MB tile array and the
// 134 MB grid, 0.1415 ms at 3.35 TB/s. A block owns a range of rows of
// the flat row space (tile, batch element, axis 0, axis 1): extended
// rows (e0, e1) for extend_tiles3d, core rows (u0, u1) for fold3d, and
// serves both channels (re 2b, im 2b + 1) of its batch element. Its
// threads are lanes x rows (kernels/mode3d.py:halo_launch): each lane
// takes kVec = 4 consecutive cells of a row's axis 2 (1 where the tile
// or halo is not a multiple of 4), each row of threads one row, and the
// block steps over `iters` rows per thread. The row coordinates are
// decoded with 32-bit divisions once per thread and then carried as the
// row advances; per row, the source and destination offsets are a few
// multiply-adds and a periodic wrap by one compare. No per-element
// division or modulo is left.
//   extend_tiles3d reads a row's ext2 complex cells as float4 pairs
//   (four cells, 32 bytes a lane) and stores their real parts to channel
//   2b and imaginary parts to 2b + 1 as float4, with the evict-first
//   hint, so that the grid stays in L2 for the halo re-reads (the
//   extended blocks are 2.53x the grid): the flat row order runs a
//   tile's rows together and its axis-2 neighbours next, its axis-1
//   neighbours nt2 tiles later. A quad never straddles the axis-2 wrap
//   (tile2 and pad are multiples of 4 when kVec = 4), so the wrap is
//   one compare per quad.
//   fold3d loads, for each quad of a core row, the at most 2 x 2 x 2
//   extended blocks that hold it (core first on each axis: the row's
//   axis-0 and axis-1 blocks are fixed per row, the axis-2 neighbour per
//   quad, uniform across it since pad and tile2 are multiples of 4) from
//   both channel planes as float4, and sums them in the order of the
//   design it replaced (re = 0, then __fadd_rn over (i, j, q) nested),
//   so its output is that design's bit for bit. It writes the four
//   complex cells as two float4. With kAxes = 2 axis 2 is one untiled
//   block with no halo. (Its loads take no cache hint: evict-first loads
//   were 18-24% slower on an H100; PERF.md section 6.)
// Every element is written once by one thread: no atomics, and both
// kernels repeat bit for bit.
#include <cuda_runtime.h>

namespace {

// Integer parameters, in this order (kernels/_build.py:mode_params).
// kAxes: the leading axes that are tiled and transformed (3, or 2 for the
// fused route, whose axis 2 has nt2 = 1, tile2 = nf2 = n2 and no halo).
// kVec .. kBlocks: the halo kernels' launch (kernels/mode3d.py:
// halo_launch).
enum ModeParam {
  kBatch, kNf0, kNf1, kNf2, kNt0, kNt1, kNt2, kTile0, kTile1, kTile2, kPad,
  kAxes, kVec, kLanes, kRows, kIters, kBlocks, kNumModeParams
};

struct Grid3 {
  int batch;
  int nf[3];    // fine grid
  int nt[3];    // tiles per axis
  int tile[3];  // core tile dims
  int pad;      // halo on each side
  int axes;     // tiled, transformed leading axes
};

Grid3 grid_from(const int* ip) {
  Grid3 g;
  g.batch = ip[kBatch];
  for (int d = 0; d < 3; ++d) {
    g.nf[d] = ip[kNf0 + d];
    g.nt[d] = ip[kNt0 + d];
    g.tile[d] = ip[kTile0 + d];
  }
  g.pad = ip[kPad];
  g.axes = ip[kAxes];
  return g;
}

// The halo kernels' launch (kernels/mode3d.py:halo_launch).
struct Halo {
  int vec;     // cells of axis 2 a lane moves at once (4 or 1)
  int lanes;   // threads along axis 2 (blockDim.x)
  int rows;    // rows a block takes at once (blockDim.y)
  int iters;   // row steps of a block
  int blocks;  // gridDim.x
};

Halo halo_from(const int* ip) {
  return Halo{ip[kVec], ip[kLanes], ip[kRows], ip[kIters], ip[kBlocks]};
}

// A row of the flat row space [nt0, nt1, nt2, batch, r0, r1] (r = e for
// extend_tiles3d, u for fold3d), decoded once and then carried.
struct Row {
  int t0, t1, t2, b, r0, r1;
};

__device__ __forceinline__ Row row_at(int row, const Grid3& g, int n0,
                                      int n1) {
  Row r;
  r.r1 = row % n1;
  row /= n1;
  r.r0 = row % n0;
  row /= n0;
  r.b = row % g.batch;
  row /= g.batch;
  r.t2 = row % g.nt[2];
  row /= g.nt[2];
  r.t1 = row % g.nt[1];
  r.t0 = row / g.nt[1];
  return r;
}

__device__ __forceinline__ void advance(Row& r, int step, const Grid3& g,
                                        int n0, int n1) {
  r.r1 += step;
  while (r.r1 >= n1) {
    r.r1 -= n1;
    if (++r.r0 < n0) continue;
    r.r0 = 0;
    if (++r.b < g.batch) continue;
    r.b = 0;
    if (++r.t2 < g.nt[2]) continue;
    r.t2 = 0;
    if (++r.t1 < g.nt[1]) continue;
    r.t1 = 0;
    ++r.t0;
  }
}

// x mod n for x in [-n, 2n): the periodic wrap of a halo cell.
__device__ __forceinline__ int wrap(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

// The first row of this thread and the end of its block's rows.
__device__ __forceinline__ int first_row(const Halo& h) {
  return (int)((long long)blockIdx.x * h.rows * h.iters) + threadIdx.y;
}

__device__ __forceinline__ int end_row(const Halo& h, int total) {
  const long long end = (long long)(blockIdx.x + 1) * h.rows * h.iters;
  return end < total ? (int)end : total;
}

template <int kVec>
__global__ void __launch_bounds__(256)
    extend_tiles3d_kernel(const float2* __restrict__ fine,
                          float* __restrict__ tiles, Grid3 g, Halo h) {
  const int e0n = g.tile[0] + 2 * g.pad, e1n = g.tile[1] + 2 * g.pad;
  const int e2n = g.tile[2] + 2 * g.pad;
  const int total = g.nt[0] * g.nt[1] * g.nt[2] * g.batch * e0n * e1n;
  const long long block = (long long)e0n * e1n * e2n;
  const int quads = e2n / kVec;
  const int end = end_row(h, total);
  int row = first_row(h);
  if (row >= end) return;
  Row r = row_at(row, g, e0n, e1n);
  for (; row < end; row += h.rows, advance(r, h.rows, g, e0n, e1n)) {
    const int x0 = wrap(r.t0 * g.tile[0] + r.r0 - g.pad, g.nf[0]);
    const int x1 = wrap(r.t1 * g.tile[1] + r.r1 - g.pad, g.nf[1]);
    const float2* src =
        fine + (((long long)r.b * g.nf[0] + x0) * g.nf[1] + x1) * g.nf[2];
    const int tile = (r.t0 * g.nt[1] + r.t1) * g.nt[2] + r.t2;
    float* re = tiles + (((long long)tile * 2 * g.batch + 2 * r.b) * e0n +
                         r.r0) * e1n * e2n + (long long)r.r1 * e2n;
    float* im = re + block;
    const int x2 = r.t2 * g.tile[2] - g.pad;
    for (int q = threadIdx.x; q < quads; q += h.lanes) {
      const int e2 = q * kVec;
      const float2* s = src + wrap(x2 + e2, g.nf[2]);
      if constexpr (kVec == 4) {
        const float4 a = reinterpret_cast<const float4*>(s)[0];
        const float4 c = reinterpret_cast<const float4*>(s)[1];
        __stcs(reinterpret_cast<float4*>(re + e2),
               make_float4(a.x, a.z, c.x, c.z));
        __stcs(reinterpret_cast<float4*>(im + e2),
               make_float4(a.y, a.w, c.y, c.w));
      } else {
        const float2 a = *s;
        __stcs(re + e2, a.x);
        __stcs(im + e2, a.y);
      }
    }
  }
}

// Per axis, the blocks that hold core cell u of tile t: the tile itself
// (extended index u + pad) and, within pad of an edge, the neighbour
// whose halo covers it. Returns how many (1 or 2); a second entry that
// is not used repeats the first.
__device__ __forceinline__ int holders(int u, int t, int tile, int pad,
                                       int nt, int* ts, int* es) {
  ts[0] = ts[1] = t;
  es[0] = es[1] = u + pad;
  if (u < pad) {  // right halo of the previous tile
    ts[1] = t == 0 ? nt - 1 : t - 1;
    es[1] = u + tile + pad;
    return 2;
  }
  if (u >= tile - pad) {  // left halo of the next
    ts[1] = t == nt - 1 ? 0 : t + 1;
    es[1] = u - tile + pad;
    return 2;
  }
  return 1;
}

template <int kVec>
__device__ __forceinline__ void add_cells(float (&acc)[kVec],
                                          const float* p) {
  if constexpr (kVec == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  } else {
    acc[0] = __fadd_rn(acc[0], *p);
  }
}

template <int kVec>
__global__ void __launch_bounds__(256)
    fold3d_kernel(const float* __restrict__ tiles,
                  float2* __restrict__ fine, Grid3 g, Halo h) {
  int ext[3], pad[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    pad[d] = d < g.axes ? g.pad : 0;
    ext[d] = g.tile[d] + 2 * pad[d];
  }
  const long long block = (long long)ext[0] * ext[1] * ext[2];
  const long long tstride = 2LL * g.batch * block;  // one tile's channels
  const int total =
      g.nt[0] * g.nt[1] * g.nt[2] * g.batch * g.tile[0] * g.tile[1];
  const int quads = g.tile[2] / kVec;
  const int end = end_row(h, total);
  int row = first_row(h);
  if (row >= end) return;
  Row r = row_at(row, g, g.tile[0], g.tile[1]);
  for (; row < end;
       row += h.rows, advance(r, h.rows, g, g.tile[0], g.tile[1])) {
    int t0s[2], e0s[2], t1s[2], e1s[2];
    const int n0 = holders(r.r0, r.t0, g.tile[0], pad[0], g.nt[0], t0s, e0s);
    const int n1 = holders(r.r1, r.t1, g.tile[1], pad[1], g.nt[1], t1s, e1s);
    // The row's offset in block (i, j), channel 2b, axis-2 tile 0.
    long long at[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        at[i][j] = (long long)((t0s[i] * g.nt[1] + t1s[j]) * g.nt[2]) *
                       tstride +
                   2LL * r.b * block +
                   ((long long)e0s[i] * ext[1] + e1s[j]) * ext[2];
      }
    }
    float2* out = fine + (((long long)r.b * g.nf[0] + r.t0 * g.tile[0] +
                           r.r0) * g.nf[1] + r.t1 * g.tile[1] + r.r1) *
                             g.nf[2] + r.t2 * g.tile[2];
    const int t2l = r.t2 == 0 ? g.nt[2] - 1 : r.t2 - 1;
    const int t2r = r.t2 == g.nt[2] - 1 ? 0 : r.t2 + 1;
    for (int q = threadIdx.x; q < quads; q += h.lanes) {
      const int u2 = q * kVec;
      long long at2[2];
      int n2 = 1;
      at2[0] = r.t2 * tstride + u2 + pad[2];
      if (u2 < pad[2]) {
        at2[1] = t2l * tstride + u2 + g.tile[2] + pad[2];
        n2 = 2;
      } else if (u2 >= g.tile[2] - pad[2]) {
        at2[1] = t2r * tstride + u2 - g.tile[2] + pad[2];
        n2 = 2;
      }
      float re[kVec], im[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) re[k] = im[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (i < n0 && j < n1 && k < n2) {
              const float* p = tiles + at[i][j] + at2[k];
              add_cells<kVec>(re, p);
              add_cells<kVec>(im, p + block);
            }
          }
        }
      }
      if constexpr (kVec == 4) {
        float4* o = reinterpret_cast<float4*>(out + u2);
        o[0] = make_float4(re[0], im[0], re[1], im[1]);
        o[1] = make_float4(re[2], im[2], re[3], im[3]);
      } else {
        out[u2] = make_float2(re[0], im[0]);
      }
    }
  }
}

}  // namespace

// fold3d: tiles [*tiles, 2B, *ext] float32 -> fine [B, *nf] complex64
// (kAxes = 2: y [nt0, nt1, 2B, E0, E1, n2] -> [B, nf0, nf1, n2]).
extern "C" int tnt_fold3d(const void* tiles, void* fine, const int* ip,
                          void* stream) {
  const Grid3 g = grid_from(ip);
  const Halo h = halo_from(ip);
  const dim3 threads(h.lanes, h.rows);
  if (h.vec == 4) {
    fold3d_kernel<4><<<h.blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (float2*)fine, g, h);
  } else {
    fold3d_kernel<1><<<h.blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (float2*)fine, g, h);
  }
  return (int)cudaGetLastError();
}

// extend_tiles3d: fine [B, *nf] complex64 -> tiles [*tiles, 2B, *ext]
// float32 (channel 2b + 0 the real part, 2b + 1 the imaginary part).
extern "C" int tnt_extend_tiles3d(const void* fine, void* tiles,
                                  const int* ip, void* stream) {
  const Grid3 g = grid_from(ip);
  const Halo h = halo_from(ip);
  const dim3 threads(h.lanes, h.rows);
  if (h.vec == 4) {
    extend_tiles3d_kernel<4><<<h.blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)fine, (float*)tiles, g, h);
  } else {
    extend_tiles3d_kernel<1><<<h.blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)fine, (float*)tiles, g, h);
  }
  return (int)cudaGetLastError();
}
