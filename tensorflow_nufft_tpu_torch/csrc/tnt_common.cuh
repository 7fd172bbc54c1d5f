// Shared definitions of the spread and interp kernels: the launch
// parameter layout (filled by kernels/_build.py:kernel_params), the tile
// geometry at rank 2 or 3, and the ES kernel (and its derivative)
// evaluated on one slot's two-float coordinate.
//
// Arithmetic note: the kernel argument z = ((i0 + j) - s) - lo and the
// Horner argument t = (z*z)*c2 - 1 are written with __fadd_rn/__fsub_rn/
// __fmul_rn so nvcc cannot contract them into FMAs: the low word lo is
// ~1e-5 grid units and only survives if every step rounds as the plain
// PyTorch (and JAX) version rounds it. The Horner loop is kept unfused
// too, so kernel and plain version evaluate identical weights.
#pragma once

#include <cuda_runtime.h>

namespace tnt {

constexpr int kMaxWidth = 16;   // plan.MAX_KERNEL_WIDTH
constexpr int kMaxHorner = 32;  // fit_horner_coeffs: degree <= 24
constexpr int kMaxRank = 3;
// The coordinate of padded slots (binning.SENTINEL): the banded interp
// leaves a sub-chunk whose first slot holds it (all its slots are padded)
// out of the rows it stages.
constexpr float kSentinel = -1.0e6f;

// Integer launch parameters, in this order (kernels/_build.py). Per-axis
// entries past the rank are 1. kDerivAxis is the interp's phi' axis, -1
// for none. The row-slab layout of the spread and interp blocks reads
// kSlab (axis-0 rows a spread block owns, or an interp piece stages; 0:
// the interp reads the tile array in place; rank 1: a spread block's
// warps, of 64 cells each, or the cells an interp stage holds), kLines
// (axis-1 lines a spread block owns), kSubLen and kRun (an interp block
// serves kRun pieces of kSubLen slots, at rank 1 in turn); the banded
// kernels also read kBand (axis-0 band rows; kSubLen is then a
// sub-chunk, the unit of a band origin) and kN2 (the fused epilogue's
// axis-2 modes). Unused entries are 0.
enum IParam {
  kRank, kNt0, kNt1, kNt2, kTile0, kTile1, kTile2, kPad, kE0, kE1, kE2,
  kChunk, kBatch2, kGroup, kSlots, kWidth, kNHorner, kThreads, kSmem,
  kDerivAxis, kBand, kSlab, kSubLen, kN2, kRun, kLines, kNumIParams
};
// Float launch parameters; the Horner coefficients follow kHorner0.
enum FParam { kHalfWidth, kC2, kBeta, kC, kHorner0 };

struct Geometry {
  int rank;
  int nt[kMaxRank];    // tiles per axis
  int tile[kMaxRank];  // core tile dims
  int pad;             // halo on each side
  int e[kMaxRank];     // extended (halo-padded) tile dims
  int chunk;           // slots per chunk
  int batch2;          // channels (2 * batch, row order (b, re/im))
  int group;           // channels per thread block
  int slots;           // num_chunks * chunk
};

struct EsKernel {
  int width;
  int deriv_axis;    // axis whose window holds phi' (-1: none)
  int n_horner;      // 0: direct exp/sqrt evaluation
  float half_width;
  float c2;          // 2 / half_width^2
  float beta;
  float c;           // 4 / width^2
  float horner[kMaxHorner];  // ascending coefficients in t
};

inline Geometry geometry_from(const int* ip) {
  Geometry g;
  g.rank = ip[kRank];
  for (int d = 0; d < kMaxRank; ++d) {
    g.nt[d] = ip[kNt0 + d];
    g.tile[d] = ip[kTile0 + d];
    g.e[d] = ip[kE0 + d];
  }
  g.pad = ip[kPad];
  g.chunk = ip[kChunk]; g.batch2 = ip[kBatch2]; g.group = ip[kGroup];
  g.slots = ip[kSlots];
  return g;
}

inline EsKernel es_from(const int* ip, const float* fp) {
  EsKernel k;
  k.width = ip[kWidth];
  k.deriv_axis = ip[kDerivAxis];
  k.n_horner = ip[kNHorner];
  k.half_width = fp[kHalfWidth];
  k.c2 = fp[kC2];
  k.beta = fp[kBeta];
  k.c = fp[kC];
  for (int i = 0; i < kMaxHorner; ++i)
    k.horner[i] = i < k.n_horner ? fp[kHorner0 + i] : 0.0f;
  return k;
}

// The row-slab layout of the spread and interp blocks, and the axis-0
// band of the rank-3 banded kernels.
struct Band {
  int band;    // rows a sub-chunk touches, from its origin zorigins[j]
  int slab;    // axis-0 rows per block (spread) or per piece (interp)
  int lines;   // spread: axis-1 lines per block
  int sublen;  // slots per sub-chunk (interp: per piece of a block)
  int n2;      // fused epilogue: modes along axis 2
  int run;     // interp: pieces of sublen slots per block (rank 1: in
               // turn)
};

inline Band band_from(const int* ip) {
  Band b;
  b.band = ip[kBand];
  b.slab = ip[kSlab];
  b.lines = ip[kLines];
  b.sublen = ip[kSubLen];
  b.n2 = ip[kN2];
  b.run = ip[kRun];
  return b;
}

__host__ __device__ inline int num_tiles(const Geometry& g) {
  return g.nt[0] * g.nt[1] * g.nt[2];
}

// The tile owning chunk kc < tile_bounds[nt] (tile t owns chunks
// tile_bounds[t] .. tile_bounds[t + 1]).
__device__ __forceinline__ int owner_tile(const int* __restrict__ tile_bounds,
                                          int nt, int kc) {
  int lo = 0, hi = nt - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_bounds[mid] <= kc) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Extended-tile origin (tile index * tile - pad) of each axis of the
// row-major tile number `tile`.
template <int kRank>
__device__ __forceinline__ void tile_origins(const Geometry& g, int tile,
                                             float* origin) {
#pragma unroll
  for (int d = kRank - 1; d >= 0; --d) {
    const int t = tile % g.nt[d];
    tile /= g.nt[d];
    origin[d] = (float)(t * g.tile[d] - g.pad);
  }
}

// phi(z) = exp(beta sqrt(1 - c z^2)) where the plan has no Horner fit;
// exactly zero outside the support.
__device__ __forceinline__ float es_eval_direct(float z, const EsKernel& k) {
  if (!(fabsf(z) < k.half_width)) return 0.0f;
  const float arg =
      fmaxf(__fsub_rn(1.0f, __fmul_rn(k.c, __fmul_rn(z, z))), 0.0f);
  return expf(__fmul_rn(k.beta, sqrtf(arg)));
}

// phi'(z) = -beta c z exp(beta r) / r, r = sqrt(max(1 - c z^2, 1e-12)),
// evaluated directly (the Horner fit approximates phi, not phi'), in the
// operation order of pallas_spread.py:es_kernel_matrix_deriv and the
// plain version (torch_ops.es_kernel_deriv); exactly zero outside the
// support.
__device__ __forceinline__ float es_eval_deriv(float z, const EsKernel& k) {
  if (!(fabsf(z) < k.half_width)) return 0.0f;
  const float arg =
      fmaxf(__fsub_rn(1.0f, __fmul_rn(__fmul_rn(k.c, z), z)), 1e-12f);
  const float r = sqrtf(arg);
  return __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(-k.beta, k.c), z),
                             expf(__fmul_rn(k.beta, r))),
                   r);
}

// The first cell ceil(s - w/2), s = hi - origin, of es_window's window
// (computed as es_window computes it, clamped as it clamps), without
// the weights: a block that needs a slot's weights only where the
// window meets its cells tests the start first.
__device__ __forceinline__ int es_start(float hi, float origin,
                                        const EsKernel& k) {
  const float f0 = ceilf(__fsub_rn(__fsub_rn(hi, origin), k.half_width));
  return (int)fminf(fmaxf(f0, -1.0e8f), 1.0e8f);
}

// phi at kW arguments z[j]: the plan's Horner fit in t = (z z) c2 - 1,
// zero where t >= 1 (outside the support), or es_eval_direct. The fit
// runs its n_horner terms, no more: a switch on n_horner (uniform across
// the grid) jumps into one unrolled run of the kMaxHorner steps, each
// step taken for every cell (kW independent chains, one switch a
// window), each indexing the coefficients with a constant, so the
// parameter struct stays in the constant bank. From acc = 0 the first
// step gives exactly horner[n - 1], the value of the predicated 32-step
// loop per cell that this replaced, whose outputs it repeats bit for bit
// at every rank.
template <int kW>
__device__ __forceinline__ void es_eval_cells(const float* z,
                                              const EsKernel& k, float* w) {
  if (k.n_horner > 0) {
    float t[kW], acc[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      t[j] = __fsub_rn(__fmul_rn(__fmul_rn(z[j], z[j]), k.c2), 1.0f);
      acc[j] = 0.0f;
    }
#define TNT_HORNER_STEP(i)                                    \
  case (i) + 1:                                               \
    _Pragma("unroll") for (int j = 0; j < kW; ++j) acc[j] =   \
        __fadd_rn(__fmul_rn(acc[j], t[j]), k.horner[(i)]);
    switch (k.n_horner) {  // each case falls through to the next
      default:  // more than kMaxHorner terms: the first kMaxHorner
      TNT_HORNER_STEP(31) TNT_HORNER_STEP(30) TNT_HORNER_STEP(29)
      TNT_HORNER_STEP(28) TNT_HORNER_STEP(27) TNT_HORNER_STEP(26)
      TNT_HORNER_STEP(25) TNT_HORNER_STEP(24) TNT_HORNER_STEP(23)
      TNT_HORNER_STEP(22) TNT_HORNER_STEP(21) TNT_HORNER_STEP(20)
      TNT_HORNER_STEP(19) TNT_HORNER_STEP(18) TNT_HORNER_STEP(17)
      TNT_HORNER_STEP(16) TNT_HORNER_STEP(15) TNT_HORNER_STEP(14)
      TNT_HORNER_STEP(13) TNT_HORNER_STEP(12) TNT_HORNER_STEP(11)
      TNT_HORNER_STEP(10) TNT_HORNER_STEP(9) TNT_HORNER_STEP(8)
      TNT_HORNER_STEP(7) TNT_HORNER_STEP(6) TNT_HORNER_STEP(5)
      TNT_HORNER_STEP(4) TNT_HORNER_STEP(3) TNT_HORNER_STEP(2)
      TNT_HORNER_STEP(1) TNT_HORNER_STEP(0)
    }
#undef TNT_HORNER_STEP
    static_assert(kMaxHorner == 32, "one Horner step per coefficient");
#pragma unroll
    for (int j = 0; j < kW; ++j) w[j] = t[j] < 1.0f ? acc[j] : 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < kW; ++j) w[j] = es_eval_direct(z[j], k);
  }
}

// One axis of a slot's kernel window: writes w[0..width) =
// phi(((i0 + j) - s) - lo) (phi' with `deriv`) with s = hi - origin,
// i0 = ceil(s - w/2), and returns i0 (clamped so far-out or NaN
// coordinates give an out-of-range start instead of an undefined
// conversion). Padded slots carry hi = SENTINEL, so their window starts
// far outside the tile. kW bounds the window array (the width when it
// is a template constant).
template <int kW = kMaxWidth>
__device__ __forceinline__ int es_window(float hi, float lo, float origin,
                                         const EsKernel& k, float* w,
                                         bool deriv = false) {
  const float s = __fsub_rn(hi, origin);
  const float f0 = ceilf(__fsub_rn(s, k.half_width));
  float z[kW], phi[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j)
    z[j] = __fsub_rn(__fsub_rn(__fadd_rn(f0, (float)j), s), lo);
  if (deriv) {
#pragma unroll
    for (int j = 0; j < kW; ++j) phi[j] = es_eval_deriv(z[j], k);
  } else {
    es_eval_cells<kW>(z, k, phi);
  }
#pragma unroll
  for (int j = 0; j < kW; ++j)
    if (j < k.width) w[j] = phi[j];
  return (int)fminf(fmaxf(f0, -1.0e8f), 1.0e8f);
}

// es_window of the banded kernels, with the kernel argument formed from
// the fine-grid row: c = ceil(hi - w/2), z_j = ((c + j) - hi) - lo,
// returning the start c - origin (origin: the extended-tile origin, plus
// the band origin zo on axis 0). Every step but the last is exact, so z
// does not depend on the tiling. es_window's s = hi - origin rounds where
// it crosses a binade (tile 0, origin -pad: up to 7.6e-6 grid units for s
// in [128, 136) at the binned level's tile 128), as the TPU kernels'
// (hi - origin) - zo does: at the 3D headline that took the binned
// level's err_impl from 4.7e-7 to 5.9e-6 on an H100 (PERF.md).
// kW bounds the window array (the width when it is a template constant).
template <int kW = kMaxWidth>
__device__ __forceinline__ int es_window_exact(float hi, float lo,
                                               float origin,
                                               const EsKernel& k, float* w) {
  const float c = ceilf(__fsub_rn(hi, k.half_width));
  float z[kW], phi[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j)
    z[j] = __fsub_rn(__fsub_rn(__fadd_rn(c, (float)j), hi), lo);
  es_eval_cells<kW>(z, k, phi);
#pragma unroll
  for (int j = 0; j < kW; ++j)
    if (j < k.width) w[j] = phi[j];
  return (int)fminf(fmaxf(__fsub_rn(c, origin), -1.0e8f), 1.0e8f);
}

}  // namespace tnt
