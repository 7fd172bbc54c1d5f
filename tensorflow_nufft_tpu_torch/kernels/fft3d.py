"""The DFT of the rank-3 mode stages: a hand-written mixed-radix FFT.

Counterpart of the DFT arithmetic of the rank-3 ``tensorflow_nufft_tpu.
kernels.pallas_dft`` pass chains (the twiddle-matrix products of
``_pass_a_kernel``, ``_pass_b_kernel``, ``_pass_c_kernel`` and
``_dual_c_kernel``, ``_dual_b_kernel``, ``_dual_a_kernel``). On the card
``fft3d_cuda`` transforms the fine grid between the halo and mode
kernels of ``kernels.mode3d``, one launch of ``csrc/fft3d.cu`` per axis;
``fft_plain`` (``torch.fft``: pocketfft on the CPU) is its plain version,
which ``fft.planar_fft`` uses for CPU tensors and for ranks 1 and 2 (which
the JAX package keeps in XLA). ``fft3d_cuda`` counts its kernel launches
in its ``launches`` attribute.

Conventions, as in the JAX package: 'forward' is the exp(-i k.x) sign,
'backward' exp(+i k.x) with no normalization.

``radices`` and ``fft_launch`` compute the kernel's stage list and launch
shape in Python, so that a CPU test can sweep them and replay the
kernel's schedule.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import _build

FFT_THREADS = 256
# Most lines a block takes, and the shared memory a launch aims to stay
# within (several blocks resident per SM); above it the lines shrink to
# 1, and then the block opts in to up to _build.SMEM_LIMIT.
FFT_MAX_COLS = 16
FFT_SMEM_TARGET = 48 * 1024
MAX_RADICES = 16


def fft_plain(x: torch.Tensor, dims, fft_direction: str) -> torch.Tensor:
    """The plain version: ``torch.fft`` over ``dims``, unnormalized in
    both directions."""
    if fft_direction == "forward":
        return torch.fft.fftn(x, dim=dims)
    return torch.fft.ifftn(x, dim=dims, norm="forward")


def radices(n: int):
    """The kernel's Stockham stages for a line of ``n``: radix 4 while it
    divides, then 2, 3 and 5. Raises for a factor above 5 (fine grids are
    even and 5-smooth)."""
    out, rest = [], n
    while rest % 4 == 0:
        out.append(4)
        rest //= 4
    for p in (2, 3, 5):
        while rest % p == 0:
            out.append(p)
            rest //= p
    if rest != 1 or n < 2 or len(out) > MAX_RADICES:
        raise ValueError(f"the FFT kernel takes lines of 2^a 3^b 5^c "
                         f"cells, at most {MAX_RADICES} stages; got {n}")
    return tuple(out)


def fft_launch(shape, dim: int):
    """(n, inner, outer, cols, pitch, contig, blocks, smem) of a launch
    along axis ``dim`` of a contiguous complex tensor of ``shape``: the
    grid seen as [outer, n, inner]. A block takes ``cols`` lines (a power
    of two): consecutive lines when ``contig`` (inner = 1), else
    consecutive columns of one outer index. Its shared memory is the
    twiddle table and two [n][pitch] buffers, pitch = cols + 1."""
    n = int(shape[dim])
    inner = int(np.prod(shape[dim + 1:], dtype=np.int64))
    outer = int(np.prod(shape[:dim], dtype=np.int64))
    contig = inner == 1

    def smem(c):
        return 8 * (n + 2 * n * (c + 1))
    cols = FFT_MAX_COLS
    while cols > 1 and smem(cols) > FFT_SMEM_TARGET:
        cols //= 2
    if smem(cols) > _build.SMEM_LIMIT:
        raise ValueError(f"a line of {n} cells exceeds the FFT kernel's "
                         f"shared memory")
    blocks = (-(-outer // cols) if contig
              else outer * -(-inner // cols))
    if n * inner >= 2 ** 31 or blocks >= 2 ** 31:
        raise ValueError(f"an FFT axis of shape {tuple(shape)} exceeds "
                         f"the kernel's 32-bit line indexing")
    return n, inner, outer, cols, cols + 1, contig, blocks, smem(cols)


def fft_params(shape, dim: int, sign: int):
    """The int parameter array of a launch, in the order of ``FftParam``
    in ``csrc/fft3d.cu``."""
    n, inner, outer, cols, pitch, contig, blocks, smem = fft_launch(shape,
                                                                    dim)
    rad = radices(n)
    ints = ((n, inner, outer, cols, cols.bit_length() - 1, pitch,
             int(contig), sign, blocks, smem, len(rad)) + rad
            + (0,) * (MAX_RADICES - len(rad)))
    return (ctypes.c_int * len(ints))(*ints)


def twiddle_table(n: int, sign: int) -> np.ndarray:
    """exp(sign 2 pi i m / n), m < n, computed in float64 and rounded
    once to complex64."""
    return np.exp(sign * 2j * np.pi * np.arange(n) / n).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _twiddles(n: int, sign: int, device) -> torch.Tensor:
    return torch.as_tensor(twiddle_table(n, sign), device=device)


def fft3d_cuda(x: torch.Tensor, dims, fft_direction: str) -> torch.Tensor:
    """Hopper ``fft_plain``: a contiguous complex64 CUDA tensor -> its
    unnormalized DFT over ``dims`` (last first), one kernel launch per
    axis; the first launch writes a new tensor, the others run in
    place."""
    _build.require_cuda("fft3d", x, "grid", torch.complex64, x.shape)
    sign = -1 if fft_direction == "forward" else 1
    lib = _build.library()
    src, out = x, torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for d in sorted((d % x.ndim for d in dims), reverse=True):
            tw = _twiddles(int(x.shape[d]), sign, x.device)
            rc = lib.tnt_fft_axis(src.data_ptr(), out.data_ptr(),
                                  tw.data_ptr(),
                                  fft_params(x.shape, d, sign), stream)
            _build.check(rc, "tnt_fft_axis launch")
            fft3d_cuda.launches += 1
            src = out
    return out


fft3d_cuda.launches = 0
