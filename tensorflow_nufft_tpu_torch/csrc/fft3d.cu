// The DFT of the rank-3 mode stages for NVIDIA Hopper: a hand-written
// mixed-radix FFT along one axis of a complex64 grid, run once per axis.
//
// It carries the DFT arithmetic of the Pallas TPU kernels
//   tensorflow_nufft_tpu/kernels/pallas_dft.py:_pass_a_kernel,
//   :_pass_b_kernel and :_pass_c_kernel (type-1), and
//   :_dual_c_kernel, :_dual_b_kernel and :_dual_a_kernel (type-2),
// which contract one axis each with twiddle matrices (the Gauss products
// of _gauss/_gauss_l). There the halo fold or extension and the
// deconvolution are built into the matrices; here they are the kernels
// of csrc/mode3d.cu (fold3d / extend_tiles3d, truncate_deconvolve3d /
// amplify_pad3d), and the DFT between them is this kernel on the full
// fine grid, one launch per axis:
//   type-1   fold3d, fft_axis on axes 2, 1, 0, truncate_deconvolve3d
//   type-2   amplify_pad3d, fft_axis on axes 2, 1, 0, extend_tiles3d
//   fused    spread_dfta (axis 2), fold2, fft_axis on axes 1 and 0,
//            truncate_deconvolve2
// A matrix-product DFT, as on the TPU, costs 8 n / (5 log2 n) times the
// flops of an FFT (51x at n = 256) and would make the stage compute-bound
// on the FP32 cores; the FFT keeps it memory-bound.
//
// Design. The grid is viewed as [outer, n, inner] (inner the product of
// the axes after the transformed one). A block takes `cols` lines: for
// inner = 1 (the last axis) `cols` consecutive lines, each n contiguous
// cells; for inner > 1 `cols` consecutive columns i of one outer index,
// so that the loads and stores of a row of the block (n fixed) are
// `cols` contiguous cells. The block reads its lines once into shared
// memory, laid out [n][pitch] with pitch = cols + 1 (no bank conflict on
// the contiguous loads), runs the Stockham autosort stages there, one
// radix per stage (4, then 2, 3, 5: the fine grid sizes are even and
// 5-smooth), ping-ponging between two buffers, and writes the lines back
// once. Each stage's butterfly j of radix R reads v[r] = a[j + r n / R],
// multiplies v[r] by w^(r k n / (ns R)) (k = j mod ns, ns the product of
// the earlier radices), does the R-point DFT and writes
// b[(j - k) R + k + r ns]. The twiddles w^m = exp(sign 2 pi i m / n) are
// a table computed in float64 on the host and rounded once
// (kernels/fft3d.py), read into shared memory by each block. Blocks own
// disjoint lines and read all of theirs before writing, so a launch may
// run in place (out == in). Index arithmetic is 32-bit within a line
// block: one modulo per butterfly, none per element. Launch shapes
// (cols, shared memory, blocks) come from kernels/fft3d.py:fft_launch.
//
// What bounds it: each launch reads and writes the grid once (the 3D
// headline's 256^3 complex64 grid is 134 MB: 0.08 ms at 3.35 TB/s), and
// does about 5 n log2 n flops a line.
#include <cuda_runtime.h>

namespace {

constexpr int kFftThreads = 256;
constexpr int kMaxRadices = 16;

// Integer parameters, in this order (kernels/fft3d.py:fft_params).
enum FftParam {
  kN, kInner, kOuter, kCols, kLogCols, kPitch, kContig, kSign, kBlocks,
  kSmem, kNumRadices, kRadix0, kNumFftParams = kRadix0 + kMaxRadices
};

struct FftAxis {
  int n, inner, outer, cols, log_cols, pitch, contig, sign, blocks, smem;
  int num_radices;
  int radix[kMaxRadices];
};

FftAxis fft_from(const int* ip) {
  FftAxis f;
  f.n = ip[kN];
  f.inner = ip[kInner];
  f.outer = ip[kOuter];
  f.cols = ip[kCols];
  f.log_cols = ip[kLogCols];
  f.pitch = ip[kPitch];
  f.contig = ip[kContig];
  f.sign = ip[kSign];
  f.blocks = ip[kBlocks];
  f.smem = ip[kSmem];
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

// in, out: [outer, n, inner] complex64 (out may be in); twiddle: [n].
__global__ void __launch_bounds__(kFftThreads)
    fft_axis_kernel(const float2* in, float2* out,
                    const float2* __restrict__ twiddle, FftAxis f) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + f.n;
  float2* alt = buf + f.n * f.pitch;
  const int tid = threadIdx.x;
  for (int m = tid; m < f.n; m += kFftThreads) tw[m] = twiddle[m];

  // The block's lines: base offset of line 0 and the count that exist.
  long long base;
  int valid, step;   // step: offset between cells m and m + 1 of a line
  if (f.contig) {
    const int first = blockIdx.x * f.cols;
    base = (long long)first * f.n;
    valid = min(f.cols, f.outer - first);
    step = 1;
  } else {
    const int per_outer = (f.inner + f.cols - 1) >> f.log_cols;
    const int o = blockIdx.x / per_outer;
    const int i0 = (blockIdx.x - o * per_outer) << f.log_cols;
    base = (long long)o * f.n * f.inner + i0;
    valid = min(f.cols, f.inner - i0);
    step = f.inner;
  }
  const float2* src = in + base;
  if (f.contig) {
    for (int c = 0; c < valid; ++c) {
      for (int m = tid; m < f.n; m += kFftThreads) {
        buf[m * f.pitch + c] = src[c * f.n + m];
      }
    }
  } else {
    const int c = tid & (f.cols - 1);
    if (c < valid) {
      for (int m = tid >> f.log_cols; m < f.n;
           m += kFftThreads >> f.log_cols) {
        buf[m * f.pitch + c] = src[m * step + c];
      }
    }
  }
  __syncthreads();

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

  float2* dst = out + base;
  if (f.contig) {
    for (int c = 0; c < valid; ++c) {
      for (int m = tid; m < f.n; m += kFftThreads) {
        dst[c * f.n + m] = buf[m * f.pitch + c];
      }
    }
  } else {
    const int c = tid & (f.cols - 1);
    if (c < valid) {
      for (int m = tid >> f.log_cols; m < f.n;
           m += kFftThreads >> f.log_cols) {
        dst[m * step + c] = buf[m * f.pitch + c];
      }
    }
  }
}

}  // namespace

// fft_axis: in [outer, n, inner] complex64 -> out (may be in), the
// unnormalized DFT along n with the sign of the twiddle table
// twiddle [n] complex64.
extern "C" int tnt_fft_axis(const void* in, void* out, const void* twiddle,
                            const int* ip, void* stream) {
  const FftAxis f = fft_from(ip);
  if (f.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f.smem);
    if (err != cudaSuccess) return (int)err;
  }
  fft_axis_kernel<<<f.blocks, kFftThreads, f.smem, (cudaStream_t)stream>>>(
      (const float2*)in, (float2*)out, (const float2*)twiddle, f);
  return (int)cudaGetLastError();
}
