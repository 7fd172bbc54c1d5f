// The rank-3 mode stages' DFT for NVIDIA Hopper: a hand-written
// mixed-radix FFT along one axis of a complex64 grid, one launch per axis
// (two for a line longer than shared memory), with the mode ends of the
// stages fused into its first load and last store.
//
// It carries the Pallas TPU kernels
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_dual_c_kernel,
//   :_dual_b_kernel and :_dual_a_kernel (type-2: modes [n0, n1, n2] to
//   the fine grid, one axis widened from modes to fine cells a pass,
//   amplification and zero padding in the matrices), and
//   :_pass_a_kernel, :_pass_b_kernel and :_pass_c_kernel (type-1: the
//   fine grid to the modes, one axis narrowed a pass, truncation and
//   deconvolution in the matrices),
// which contract one axis each with twiddle matrices. Here each pass is
// an FFT of the lines of one axis, pruned as the TPU's matrices are:
//   type-2  axis 2: the n0 n1 lines at mode slots, read from the planar
//           modes with the deconvolution weights, each placed at slot
//           (k - n/2) mod nf of a zero line -> [B, n0, n1, nf2];
//           axis 1: n0 nf2 lines, modes in -> [B, n0, nf1, nf2];
//           axis 0: nf1 nf2 lines, modes in -> the fine grid, which
//           csrc/mode3d.cu extend_tiles3d windows into tiles;
//   type-1  (the fine grid from mode3d.cu fold3d) axis 2: every line,
//           its n2 mode outputs kept -> [B, nf0, nf1, n2]; axis 1: nf0 n2
//           lines, n1 kept -> [B, nf0, n1, n2]; axis 0: n1 n2 lines, the
//           n0 mode outputs stored planar with the weights
//           -> [B, n0, n1, n2, 2];
//   fused   (y from fold3d with kAxes 2: axis 2 already in modes) axes 1
//           and 0 as type-1's, the weights of axes 0 and 1.
// A line that is skipped is all zeros (its FFT is zero) and a cell that
// is never stored is one the truncation drops, so each kept value is the
// full-grid FFT's, bit for bit but for the sign of zeros; the weights
// keep the rounding of the kernels they replace, __fmul_rn(__fmul_rn(w0,
// w1), w2) and then __fmul_rn(v, wt). A matrix-product DFT, as on the
// TPU, costs 8 n / (5 log2 n) times the flops of an FFT (51x at n = 256)
// and would make the stage compute-bound on the FP32 cores; the FFT
// keeps it memory-bound.
//
// Design. A launch transforms the lines of one axis of length n of a grid
// seen as [outer, n, inner]. Its lines are indexed (o, r, c), c < inner
// fastest, then r < split (1 but for a split line), then o; block b takes
// the `cols` lines from b cols (a power of two). Cell m of line (o, r, c)
// is the axis' cell s = m step + r split_step, on each side: the input
// holds len_in cells of the axis a line (nf, or the n_modes of a modes
// side, where cell s is mode mode_of(s) or absent, read as zero), the
// output len_out. A side whose line cells are contiguous (inner = 1 and
// step = 1) is read or written a line at a time with the threads along
// the line; any other side with the threads across the block's lines,
// whose cells of equal m are adjacent, so both are coalesced. The block
// decodes each of its lines once (their offsets, in shared memory after
// the buffers), reads its lines once into shared memory, laid out
// [n][pitch] with pitch = cols + 1, runs the Stockham autosort stages
// there, one radix per stage (4, then 2, 3, 5: the fine grid sizes are
// even and 5-smooth), ping-ponging between two buffers, and writes the
// lines back once. Each stage's butterfly j of radix R reads
// v[r] = a[j + r n / R], multiplies v[r] by w^(r k n / (ns R)) (k = j mod
// ns, ns the product of the earlier radices), does the R-point DFT and
// writes b[(j - k) R + k + r ns]. The twiddles w^m = exp(sign 2 pi i m / n) are
// a table computed in float64 on the host and rounded once
// (kernels/fft3d.py), read into shared memory by each block. Blocks own
// disjoint lines and read all of theirs before writing, so a dense
// launch may run in place (out == in).
//
// A line longer than shared memory (40 n + 24 bytes above 227 KB:
// n > 5810)
// takes two launches, the four-step split n = n1 n2: the first
// transforms the n2 columns of the line seen as [n1, n2] (split = n2,
// step n2) and multiplies cell (k1, b) by w_n^(b k1) at its store; the
// second transforms the n1 rows (split = n1, step 1, split step n2) and
// writes cell k1 + n1 k2 (step n1) of the output, out of place. Launch
// shapes, splits and sides come from kernels/fft3d.py:axis_launches.
//
// What bounds it: bytes. A pruned pass reads and writes its two grids
// once (at the 3D headline's 128^3 modes and 256^3 fine grid, type-2
// moves 16.8 -> 33.6 -> 67.1 -> 134.2 MB, 352 MB in all: 0.105 ms at
// 3.35 TB/s, against 956 MB for a padded grid and three full passes),
// and does about 5 n log2 n flops a line. Each thread keeps four loads
// or stores in flight. Measured on an H100 (PERF.md), a pass over every
// line of the 256^3 grid takes about 0.14 ms whatever its bytes (the
// shared-memory stages and their barriers), one over a quarter of the
// lines 0.05 ms.
#include <cuda_runtime.h>

namespace {

constexpr int kFftThreads = 256;
constexpr int kMaxRadices = 16;
constexpr int kUnroll = 4;  // cells a thread loads or stores at once

// Integer parameters, in this order (kernels/fft3d.py:fft_params).
// A side: the cells of the axis a line holds, whether they are modes,
// the step of cell m and of the split index r along the axis.
enum FftParam {
  kN, kCols, kLogCols, kPitch, kSign, kBlocks, kSmem, kOuter, kSplit,
  kInner, kInLen, kInModes, kInStep, kInSplitStep, kOutLen, kOutModes,
  kOutStep, kOutSplitStep, kAxisN, kModes, kTwiddleStore, kLoadWeights,
  kStoreWeights, kWn0, kWn1, kWn2, kNumRadices, kRadix0,
  kNumFftParams = kRadix0 + kMaxRadices
};

struct Side {
  int len, modes, step, split_step;
};

struct FftAxis {
  int n, cols, log_cols, pitch, sign, blocks, smem;
  int outer, split, inner;
  Side in, out;
  int axis_n;         // cells of the axis (n, or n1 n2 of a split)
  int modes;          // modes of the axis, on a modes side
  int twiddle_store;  // first launch of a split: w_n^(r m) at the store
  int load_weights;   // type-2 axis 2: weights of line (i, j) and mode k
  int store_weights;  // type-1 axis 0: 3 (w0 w1 w2) or 2 (w0 w1)
  int wn0, wn1, wn2;  // mode counts that decode a line's weights
  int num_radices;
  int radix[kMaxRadices];
};

FftAxis fft_from(const int* ip) {
  FftAxis f;
  f.n = ip[kN];
  f.cols = ip[kCols];
  f.log_cols = ip[kLogCols];
  f.pitch = ip[kPitch];
  f.sign = ip[kSign];
  f.blocks = ip[kBlocks];
  f.smem = ip[kSmem];
  f.outer = ip[kOuter];
  f.split = ip[kSplit];
  f.inner = ip[kInner];
  f.in = Side{ip[kInLen], ip[kInModes], ip[kInStep], ip[kInSplitStep]};
  f.out = Side{ip[kOutLen], ip[kOutModes], ip[kOutStep], ip[kOutSplitStep]};
  f.axis_n = ip[kAxisN];
  f.modes = ip[kModes];
  f.twiddle_store = ip[kTwiddleStore];
  f.load_weights = ip[kLoadWeights];
  f.store_weights = ip[kStoreWeights];
  f.wn0 = ip[kWn0];
  f.wn1 = ip[kWn1];
  f.wn2 = ip[kWn2];
  f.num_radices = ip[kNumRadices];
  for (int s = 0; s < kMaxRadices; ++s) f.radix[s] = ip[kRadix0 + s];
  return f;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 scale(float2 v, float wt) {
  return make_float2(__fmul_rn(v.x, wt), __fmul_rn(v.y, wt));
}

// The R-point DFT of v in place, with w_R^p = tw[p * (n / R)].
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R], const float2* tw,
                                    int n_over_r, int sign) {
  if (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if (R == 4) {
    // w_4 = sign * i exactly.
    const float2 a = cadd(v[0], v[2]), b = csub(v[0], v[2]);
    const float2 c = cadd(v[1], v[3]), e = csub(v[1], v[3]);
    const float2 d = make_float2(-sign * e.y, sign * e.x);
    v[0] = cadd(a, c);
    v[1] = cadd(b, d);
    v[2] = csub(a, c);
    v[3] = csub(b, d);
  } else {
    float2 y[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float2 acc = v[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        acc = cadd(acc, cmul(v[r], tw[((r * q) % R) * n_over_r]));
      }
      y[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = y[q];
  }
}

// One Stockham stage of radix R over the block's `cols` lines: src and
// dst are [n][pitch] in shared memory; ns is the product of the earlier
// radices.
template <int R>
__device__ void stage(const float2* src, float2* dst, const float2* tw,
                      const FftAxis& f, int ns) {
  const int nr = f.n / R;
  const int span = f.n / (ns * R);
  const int count = nr << f.log_cols;
  for (int b = threadIdx.x; b < count; b += kFftThreads) {
    const int c = b & (f.cols - 1);
    const int j = b >> f.log_cols;
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[(j + r * nr) * f.pitch + c];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * k * span]);
    dft<R>(v, tw, nr, f.sign);
    const int o = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[(o + r * ns) * f.pitch + c] = v[r];
  }
}

// Mode index of axis cell x (axis of nf cells, n modes; mode i has
// frequency i - n/2 and lives at (i - n/2) mod nf), or -1 if x holds
// none.
__device__ __forceinline__ int mode_of(int x, int n, int nf) {
  if (x < n - n / 2) return x + n / 2;
  if (x >= nf - n / 2) return x - nf + n / 2;
  return -1;
}

// One line of a side: the offset of its axis cell 0, the axis offset of
// its cell 0 (r split_step), its split index and, where the side carries
// the weights, their factors for the line. A block decodes each of its
// lines once per side into shared memory (refs, after the buffers).
struct LineRef {
  long long base;
  int q, r;
  float wa, wb;
};

__device__ __forceinline__ LineRef line_ref(int line, const FftAxis& f,
                                            const Side& sd, bool loading,
                                            const float* w0, const float* w1,
                                            const float* w2) {
  const int c = line % f.inner;
  const int t = line / f.inner;
  LineRef L;
  L.r = t % f.split;
  const int o = t / f.split;
  L.base = (long long)o * sd.len * f.inner + c;
  L.q = L.r * sd.split_step;
  L.wa = L.wb = 1.0f;
  if (loading && f.load_weights) {
    // o = (b n0 + i) n1 + j: the line's w0[i] w1[j], rounded once.
    L.wa = __fmul_rn(w0[(o / f.wn1) % f.wn0], w1[o % f.wn1]);
  } else if (!loading && f.store_weights) {
    // c = j n2 + k: the column's w1[j] and w2[k].
    L.wa = w1[c / f.wn2];
    if (f.store_weights == 3) L.wb = w2[c % f.wn2];
  }
  return L;
}

__device__ __forceinline__ float2 load_cell(const float2* in,
                                            const LineRef& L, int m,
                                            const FftAxis& f,
                                            const float* w2) {
  const int s = m * f.in.step + L.q;
  if (!f.in.modes) return in[L.base + s * f.inner];
  const int k = mode_of(s, f.modes, f.axis_n);
  if (k < 0) return make_float2(0.0f, 0.0f);
  const float2 v = in[L.base + k * f.inner];
  return f.load_weights ? scale(v, __fmul_rn(L.wa, w2[k])) : v;
}

__device__ __forceinline__ void store_cell(float2* out, const LineRef& L,
                                           int m, float2 v, const FftAxis& f,
                                           const float2* twiddle_long,
                                           const float* w0) {
  const int s = m * f.out.step + L.q;
  if (f.twiddle_store) v = cmul(v, twiddle_long[L.r * m]);
  if (!f.out.modes) {
    out[L.base + s * f.inner] = v;
    return;
  }
  const int k = mode_of(s, f.modes, f.axis_n);
  if (k < 0) return;
  if (f.store_weights) {
    float wt = __fmul_rn(w0[k], L.wa);
    if (f.store_weights == 3) wt = __fmul_rn(wt, L.wb);
    v = scale(v, wt);
  }
  out[L.base + k * f.inner] = v;
}

// Whether a side's line cells are contiguous: then the threads run along
// each line, else across the block's lines.
__device__ __forceinline__ bool along(const Side& sd, const FftAxis& f) {
  return f.inner == 1 && sd.step == 1;
}

// in: the input side's grid; out: the output side's (may be in for a
// dense launch); twiddle: [n]; twiddle_long: [axis_n] (a split's first
// launch); w0, w1, w2: the deconvolution weights (a weighted side).
__global__ void __launch_bounds__(kFftThreads)
    fft_axis_kernel(const float2* in, float2* out,
                    const float2* __restrict__ twiddle,
                    const float2* __restrict__ twiddle_long,
                    const float* __restrict__ w0,
                    const float* __restrict__ w1,
                    const float* __restrict__ w2, FftAxis f) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + f.n;
  float2* alt = buf + f.n * f.pitch;
  LineRef* refs = reinterpret_cast<LineRef*>(alt + f.n * f.pitch);
  const int tid = threadIdx.x;
  for (int m = tid; m < f.n; m += kFftThreads) tw[m] = twiddle[m];

  const int lines = f.outer * f.split * f.inner;
  const int first = blockIdx.x << f.log_cols;
  const int valid = min(f.cols, lines - first);
  if (tid < valid) refs[tid] = line_ref(first + tid, f, f.in, true, w0, w1,
                                        w2);
  __syncthreads();
  // Each thread issues kUnroll loads before their shared stores, so that
  // they are in flight together.
  float2 v[kUnroll];
  if (along(f.in, f)) {
    for (int m = tid; m < f.n; m += kFftThreads) {
      for (int c0 = 0; c0 < valid; c0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u < valid) v[u] = load_cell(in, refs[c0 + u], m, f, w2);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u < valid) buf[m * f.pitch + c0 + u] = v[u];
        }
      }
    }
  } else {
    const int c = tid & (f.cols - 1);
    const int step = kFftThreads >> f.log_cols;
    if (c < valid) {
      const LineRef L = refs[c];
      for (int m0 = tid >> f.log_cols; m0 < f.n; m0 += kUnroll * step) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (m0 + u * step < f.n) {
            v[u] = load_cell(in, L, m0 + u * step, f, w2);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (m0 + u * step < f.n) buf[(m0 + u * step) * f.pitch + c] = v[u];
        }
      }
    }
  }
  __syncthreads();
  // The output side's lines; the stages' barriers order them before the
  // store.
  if (tid < valid) refs[tid] = line_ref(first + tid, f, f.out, false, w0,
                                        w1, w2);

  int ns = 1;
  for (int s = 0; s < f.num_radices; ++s) {
    const int r = f.radix[s];
    if (r == 4) {
      stage<4>(buf, alt, tw, f, ns);
    } else if (r == 2) {
      stage<2>(buf, alt, tw, f, ns);
    } else if (r == 3) {
      stage<3>(buf, alt, tw, f, ns);
    } else {
      stage<5>(buf, alt, tw, f, ns);
    }
    ns *= r;
    __syncthreads();
    float2* t = buf;
    buf = alt;
    alt = t;
  }

  if (along(f.out, f)) {
    for (int m = tid; m < f.n; m += kFftThreads) {
      for (int c0 = 0; c0 < valid; c0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u < valid) v[u] = buf[m * f.pitch + c0 + u];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u < valid) {
            store_cell(out, refs[c0 + u], m, v[u], f, twiddle_long, w0);
          }
        }
      }
    }
  } else {
    const int c = tid & (f.cols - 1);
    const int step = kFftThreads >> f.log_cols;
    if (c < valid) {
      const LineRef L = refs[c];
      for (int m0 = tid >> f.log_cols; m0 < f.n; m0 += kUnroll * step) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (m0 + u * step < f.n) v[u] = buf[(m0 + u * step) * f.pitch + c];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (m0 + u * step < f.n) {
            store_cell(out, L, m0 + u * step, v[u], f, twiddle_long, w0);
          }
        }
      }
    }
  }
}

}  // namespace

// fft_axis: one launch of kernels/fft3d.py:axis_launches (the unnormalized
// DFT along one axis, with the sign of the twiddle table twiddle [n]
// complex64): in -> out (may be in for a dense launch), twiddle_long
// [axis_n] for a split's first launch (else unread), w0, w1, w2 the
// deconvolution weights [n_d] float32 of a weighted side (else unread).
extern "C" int tnt_fft_axis(const void* in, void* out, const void* twiddle,
                            const void* twiddle_long, const void* w0,
                            const void* w1, const void* w2, const int* ip,
                            void* stream) {
  const FftAxis f = fft_from(ip);
  if (f.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f.smem);
    if (err != cudaSuccess) return (int)err;
  }
  fft_axis_kernel<<<f.blocks, kFftThreads, f.smem, (cudaStream_t)stream>>>(
      (const float2*)in, (float2*)out, (const float2*)twiddle,
      (const float2*)twiddle_long, (const float*)w0, (const float*)w1,
      (const float*)w2, f);
  return (int)cudaGetLastError();
}
