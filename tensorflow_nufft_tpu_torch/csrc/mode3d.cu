// Rank-3 mode stages for NVIDIA Hopper: the hand-written kernels around
// cuFFT (torch.fft) of the 3D planar NUFFT.
//
// Type-1 post-stage, replacing the Pallas TPU kernels
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_pass_a_kernel,
//   :_pass_b_kernel and :_pass_c_kernel
// (the periodic overlap-add of the tile halos, the DFT, truncation to the
// n modes and deconvolution, one axis per pass as matrix products):
//   fold3d               tiles [*tiles, 2B, *ext] f32 -> complex64 fine
//                        grid [B, *nf] (re/im interleaved, cuFFT's input)
//   (torch.fft.fftn / ifftn over the three axes)
//   truncate_deconvolve3d  spectrum at the mode slots k mod nf, times
//                        w0[i] * w1[j] * w2[k] -> planar [B, n0, n1, n2, 2]
// Type-2 pre-stage, replacing
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_dual_c_kernel,
//   :_dual_b_kernel and :_dual_a_kernel
// (amplification, zero-padding, the DFT and halo windowing):
//   amplify_pad3d        planar modes -> complex64 fine grid, the weighted
//                        mode at a mode slot and 0 elsewhere (every cell
//                        is written, so there is no memset)
//   (torch.fft)
//   extend_tiles3d       complex64 fine grid -> [*tiles, 2B, *ext] f32
//                        with periodic halos
// The TPU computes the DFT as matrix products only because it has no
// usable complex FFT; everything else those six kernels do is here.
//
// Two-axis variants (kAxes = 2), the stages after the fused banded
// spread (csrc/spread.cu, replacing pallas_spread.py:
// _spread_kernel_split_banded_dfta, whose epilogue already contracted
// axis 2 to its n2 modes with the deconvolving twiddles), replacing
// pallas_dft.py:_pass_b_kernel and :_pass_c_kernel on that route
// (_run_passes_bc):
//   fold3d               y [nt0, nt1, 2B, E0, E1, n2] -> complex64
//                        [B, nf0, nf1, n2]: the overlap-add of axes 0 and
//                        1 only (axis 2 is one untiled block of n2)
//   (torch.fft over axes 0 and 1)
//   truncate_deconvolve3d  the mode slots and weights of axes 0 and 1;
//                        axis 2 is already in mode order and weighted
//
// Design. Each kernel is a gather: one thread per output element, with a
// grid-stride loop, so every element is written once, without atomics,
// and the results are deterministic. fold3d sums, for each fine cell, the
// at most 2 x 2 x 2 extended blocks that hold it (its core tile and, on
// each axis where it lies within `pad` of a tile edge, the neighbouring
// tile's halo), in a fixed order. Consecutive threads take consecutive
// elements of the last axis, so reads and writes are coalesced along it.
//
// What bounds them on the H100: memory traffic. Each kernel does a few
// integer operations and at most 8 additions per element; at the 3D
// headline (128^3 modes, fine 256^3, tiles 16 x 16 x 4 of ext
// (24, 24, 72), batch 1) fold3d reads the 340 MB tile array and writes the
// 134 MB grid, extend_tiles3d the reverse, and the truncate/amplify pair
// moves the 134 MB grid and the 17 MB of modes. The gathers read the
// halos twice and the layouts are not re-tiled for the TPU-style
// streaming; making them reach the bandwidth bound is later work.
#include <cuda_runtime.h>

namespace {

// Integer parameters, in this order (kernels/_build.py:mode_params).
// kAxes: the leading axes that are tiled and transformed (3, or 2 for the
// fused route, whose axis 2 has nt2 = 1, tile2 = nf2 = n2 and no halo).
enum ModeParam {
  kBatch, kNf0, kNf1, kNf2, kN0, kN1, kN2, kNt0, kNt1, kNt2, kTile0,
  kTile1, kTile2, kPad, kAxes, kNumModeParams
};

struct Grid3 {
  int batch;
  int nf[3];    // fine grid
  int n[3];     // modes
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
    g.n[d] = ip[kN0 + d];
    g.nt[d] = ip[kNt0 + d];
    g.tile[d] = ip[kTile0 + d];
  }
  g.pad = ip[kPad];
  g.axes = ip[kAxes];
  return g;
}

constexpr int kThreads = 256;

dim3 blocks_for(long long total) {
  // Grid-stride loops: enough blocks to fill the card, no more.
  long long b = (total + kThreads - 1) / kThreads;
  return dim3((unsigned)(b < 132 * 64 ? (b > 0 ? b : 1) : 132 * 64));
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long stride() {
  return (long long)gridDim.x * blockDim.x;
}

// Mode index i of fine index x along an axis with n modes and nf fine
// cells (mode i has frequency i - n/2 and lives at (i - n/2) mod nf), or
// -1 if x holds no mode.
__device__ __forceinline__ int mode_of(int x, int n, int nf) {
  if (x < n - n / 2) return x + n / 2;
  if (x >= nf - n / 2) return x - nf + n / 2;
  return -1;
}

__global__ void fold3d_kernel(const float* __restrict__ tiles,
                              float2* __restrict__ fine, Grid3 g) {
  int ext[3], pad[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    pad[d] = d < g.axes ? g.pad : 0;
    ext[d] = g.tile[d] + 2 * pad[d];
  }
  const long long block = (long long)ext[0] * ext[1] * ext[2];
  const int b2 = 2 * g.batch;
  const long long total =
      (long long)g.batch * g.nf[0] * g.nf[1] * g.nf[2];
  for (long long idx = first_index(); idx < total; idx += stride()) {
    long long rem = idx;
    int x[3];
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      x[d] = (int)(rem % g.nf[d]);
      rem /= g.nf[d];
    }
    const int b = (int)rem;
    // Per axis, the blocks that hold x: its core tile, and the
    // neighbour whose halo covers it when x is within pad of an edge.
    int ct[3][2], ce[3][2], cn[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int t = x[d] / g.tile[d];
      const int u = x[d] - t * g.tile[d];
      ct[d][0] = t;
      ce[d][0] = u + pad[d];
      cn[d] = 1;
      if (u < pad[d]) {  // right halo of the previous tile
        ct[d][1] = (t + g.nt[d] - 1) % g.nt[d];
        ce[d][1] = u + g.tile[d] + pad[d];
        cn[d] = 2;
      } else if (u >= g.tile[d] - pad[d]) {  // left halo of the next
        ct[d][1] = (t + 1) % g.nt[d];
        ce[d][1] = u - g.tile[d] + pad[d];
        cn[d] = 2;
      }
    }
    float re = 0.0f, im = 0.0f;
    for (int i = 0; i < cn[0]; ++i) {
      for (int j = 0; j < cn[1]; ++j) {
        for (int q = 0; q < cn[2]; ++q) {
          const long long t =
              ((long long)ct[0][i] * g.nt[1] + ct[1][j]) * g.nt[2] +
              ct[2][q];
          const long long off =
              (t * b2 + 2 * b) * block +
              ((long long)ce[0][i] * ext[1] + ce[1][j]) * ext[2] + ce[2][q];
          re = __fadd_rn(re, tiles[off]);
          im = __fadd_rn(im, tiles[off + block]);
        }
      }
    }
    fine[idx] = make_float2(re, im);
  }
}

__global__ void truncate_deconvolve3d_kernel(
    const float2* __restrict__ spec, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ w2,
    float2* __restrict__ out, Grid3 g) {
  const long long total = (long long)g.batch * g.n[0] * g.n[1] * g.n[2];
  for (long long idx = first_index(); idx < total; idx += stride()) {
    long long rem = idx;
    int m[3], slot[3];
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      m[d] = (int)(rem % g.n[d]);
      rem /= g.n[d];
      slot[d] = d < g.axes ? (m[d] - g.n[d] / 2 + g.nf[d]) % g.nf[d] : m[d];
    }
    const long long b = rem;
    const float2 v =
        spec[((b * g.nf[0] + slot[0]) * g.nf[1] + slot[1]) * g.nf[2] +
             slot[2]];
    float wt = __fmul_rn(w0[m[0]], w1[m[1]]);
    if (g.axes == 3) wt = __fmul_rn(wt, w2[m[2]]);
    out[idx] = make_float2(__fmul_rn(v.x, wt), __fmul_rn(v.y, wt));
  }
}

__global__ void amplify_pad3d_kernel(const float2* __restrict__ modes,
                                     const float* __restrict__ w0,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ w2,
                                     float2* __restrict__ fine, Grid3 g) {
  const long long total =
      (long long)g.batch * g.nf[0] * g.nf[1] * g.nf[2];
  for (long long idx = first_index(); idx < total; idx += stride()) {
    long long rem = idx;
    int m[3];
    bool hit = true;
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      const int x = (int)(rem % g.nf[d]);
      rem /= g.nf[d];
      m[d] = mode_of(x, g.n[d], g.nf[d]);
      hit = hit && m[d] >= 0;
    }
    float2 val = make_float2(0.0f, 0.0f);
    if (hit) {
      const long long b = rem;
      const float2 v =
          modes[((b * g.n[0] + m[0]) * g.n[1] + m[1]) * g.n[2] + m[2]];
      const float wt = __fmul_rn(__fmul_rn(w0[m[0]], w1[m[1]]), w2[m[2]]);
      val = make_float2(__fmul_rn(v.x, wt), __fmul_rn(v.y, wt));
    }
    fine[idx] = val;
  }
}

__global__ void extend_tiles3d_kernel(const float* __restrict__ fine,
                                      float* __restrict__ tiles, Grid3 g) {
  int ext[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) ext[d] = g.tile[d] + 2 * g.pad;
  const int b2 = 2 * g.batch;
  const long long total = (long long)g.nt[0] * g.nt[1] * g.nt[2] * b2 *
                          ext[0] * ext[1] * ext[2];
  for (long long idx = first_index(); idx < total; idx += stride()) {
    long long rem = idx;
    int e[3], t[3];
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      e[d] = (int)(rem % ext[d]);
      rem /= ext[d];
    }
    const int c = (int)(rem % b2);
    rem /= b2;
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      t[d] = (int)(rem % g.nt[d]);
      rem /= g.nt[d];
    }
    long long fidx = c / 2;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int x = (t[d] * g.tile[d] + e[d] - g.pad + g.nf[d]) % g.nf[d];
      fidx = fidx * g.nf[d] + x;
    }
    tiles[idx] = fine[2 * fidx + (c & 1)];
  }
}

}  // namespace

// fold3d: tiles [*tiles, 2B, *ext] float32 -> fine [B, *nf] complex64
// (kAxes = 2: y [nt0, nt1, 2B, E0, E1, n2] -> [B, nf0, nf1, n2]).
extern "C" int tnt_fold3d(const void* tiles, void* fine, const int* ip,
                          void* stream) {
  const Grid3 g = grid_from(ip);
  const long long total = (long long)g.batch * g.nf[0] * g.nf[1] * g.nf[2];
  fold3d_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tiles, (float2*)fine, g);
  return (int)cudaGetLastError();
}

// truncate_deconvolve3d: spectrum [B, *nf] complex64 and the per-axis
// deconvolution weights w_d [n_d] float32 -> out [B, *n, 2] float32
// (kAxes = 2: nf2 = n2, axis 2 passed through and w2 unread).
extern "C" int tnt_truncate_deconvolve3d(const void* spec, const void* w0,
                                         const void* w1, const void* w2,
                                         void* out, const int* ip,
                                         void* stream) {
  const Grid3 g = grid_from(ip);
  const long long total = (long long)g.batch * g.n[0] * g.n[1] * g.n[2];
  truncate_deconvolve3d_kernel<<<blocks_for(total), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float2*)spec, (const float*)w0, (const float*)w1,
      (const float*)w2, (float2*)out, g);
  return (int)cudaGetLastError();
}

// amplify_pad3d: modes [B, *n, 2] float32 and the per-axis weights ->
// fine [B, *nf] complex64 (every cell written).
extern "C" int tnt_amplify_pad3d(const void* modes, const void* w0,
                                 const void* w1, const void* w2, void* fine,
                                 const int* ip, void* stream) {
  const Grid3 g = grid_from(ip);
  const long long total = (long long)g.batch * g.nf[0] * g.nf[1] * g.nf[2];
  amplify_pad3d_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float2*)modes, (const float*)w0, (const float*)w1,
      (const float*)w2, (float2*)fine, g);
  return (int)cudaGetLastError();
}

// extend_tiles3d: fine [B, *nf] complex64 -> tiles [*tiles, 2B, *ext]
// float32 (channel 2b + 0 the real part, 2b + 1 the imaginary part).
extern "C" int tnt_extend_tiles3d(const void* fine, void* tiles,
                                  const int* ip, void* stream) {
  const Grid3 g = grid_from(ip);
  const long long total = (long long)g.nt[0] * g.nt[1] * g.nt[2] *
                          (2 * g.batch) * (g.tile[0] + 2 * g.pad) *
                          (g.tile[1] + 2 * g.pad) * (g.tile[2] + 2 * g.pad);
  extend_tiles3d_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)fine, (float*)tiles, g);
  return (int)cudaGetLastError();
}
