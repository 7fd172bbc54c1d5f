"""The DFT of the rank-3 mode stages: a hand-written mixed-radix FFT,
pruned to the lines the TPU passes touch, with the mode ends fused in.

Counterpart of the rank-3 ``tensorflow_nufft_tpu.kernels.pallas_dft``
pass chains: ``_dual_c_kernel``, ``_dual_b_kernel`` and
``_dual_a_kernel`` (type-2: modes to the fine grid, amplified and
zero-padded, one axis widened a pass) and ``_pass_a_kernel``,
``_pass_b_kernel`` and ``_pass_c_kernel`` (type-1: the fine grid to the
modes, truncated and deconvolved, one axis narrowed a pass). On the card
each pass is one launch of ``csrc/fft3d.cu`` (two for a line longer than
shared memory):

- ``modes_to_fine_cuda``: planar modes [B, n0, n1, n2, 2] -> complex
  fine grid [B, nf0, nf1, nf2] (then ``mode3d.extend_tiles3d_cuda``);
- ``fine_to_modes_cuda``: the fine grid (from ``mode3d.fold3d_cuda``)
  -> planar modes; with ``axes=2`` the fused route's [B, nf0, nf1, n2]
  (from ``mode3d.fold2_cuda``: axis 2 already in modes and weighted);
- ``fft3d_cuda``: the full-grid FFT over ``dims`` with the same kernel,
  on no path of the port: ``chip_smoke.py`` holds it to ``torch.fft``.

Each counts its kernel launches in its ``launches`` attribute. The plain
versions are ``torch.fft`` (``fft_plain``) between ``mode3d``'s
``amplify_pad_plain`` and ``truncate_deconvolve_plain``, which
``fft.planar_fft`` uses for CPU tensors and for ranks 1 and 2 (which the
JAX package keeps in XLA).

Conventions, as in the JAX package: 'forward' is the exp(-i k.x) sign,
'backward' exp(+i k.x) with no normalization; mode index i of an axis of
n modes and nf fine cells lives at fine cell (i - n//2) mod nf.

``radices``, ``split_of`` and ``axis_launches`` compute the kernel's
stage lists, splits and launch shapes in Python, so that a CPU test can
sweep them and replay each launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import _build
from tensorflow_nufft_tpu_torch.kernels.mode3d import deconv_weights

FFT_THREADS = 256
# Most lines a block takes, and the shared memory a launch aims to stay
# within: three blocks an SM. Above it the lines halve down to 1, and
# then the block opts in to up to _build.SMEM_LIMIT; a line that does
# not fit then is split in two launches (``split_of``). On an H100 the
# three-block target took 16 lines at n = 256 (72 KB) and 8 at n = 320,
# the fastest settings of a sweep over 4-32 lines and 48 or 160 KB
# (``tools/torch_halo_probe.py --fft --sweep``; PERF.md).
FFT_MAX_COLS = 16
FFT_SMEM_TARGET = _build.SMEM_LIMIT // 3
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


# Bytes of a line's decoded offsets in shared memory (LineRef).
LINE_REF_BYTES = 24


def _smem(n: int, cols: int) -> int:
    """Shared memory of a block: the twiddle table, two [n][cols + 1]
    buffers and its lines' offsets."""
    return 8 * (n + 2 * n * (cols + 1)) + LINE_REF_BYTES * cols


def _fits(n: int) -> bool:
    return _smem(n, 1) <= _build.SMEM_LIMIT


def split_of(n: int):
    """(n1, n2) of the four-step split of a line of ``n`` cells too long
    for one block's shared memory (n1 n2 = n, n1 >= n2, n1 the least such
    that both fit), or None where the line fits."""
    if _fits(n):
        return None
    for n1 in range(int(np.ceil(np.sqrt(n))), n):
        if n % n1 == 0 and _fits(n1) and _fits(n // n1):
            return n1, n // n1
    raise ValueError(f"a line of {n} cells has no split that fits the FFT "
                     f"kernel's shared memory")


class Side(NamedTuple):
    """One side of a launch: ``len`` cells of the axis a line holds
    (``modes`` or the fine n), whether they are modes, and the step of
    line cell m and of the split index r along the axis."""
    len: int
    modes: bool
    step: int
    split_step: int


class Launch(NamedTuple):
    """One launch of ``fft_axis_kernel``: lines of ``n`` cells indexed
    (o, r, c), o < outer, r < split, c < inner (fastest), ``cols`` a
    block; cell m of line (o, r, c) is axis cell m step + r split_step of
    each side, at [o, axis cell or mode, c] of that side's grid
    [outer, len, inner]."""
    n: int
    outer: int
    split: int
    inner: int
    src: Side
    dst: Side
    axis_n: int
    modes: int
    twiddle_store: bool
    cols: int
    pitch: int
    blocks: int
    smem: int


def _launch(n, outer, split, inner, src, dst, axis_n, modes, twiddle_store
            ) -> Launch:
    cols = FFT_MAX_COLS
    while cols > 1 and _smem(n, cols) > FFT_SMEM_TARGET:
        cols //= 2
    lines = outer * split * inner
    blocks = -(-lines // cols)
    if (lines >= 2 ** 31 or blocks >= 2 ** 31
            or max(src.len, dst.len, axis_n) * inner >= 2 ** 31):
        raise ValueError(f"an FFT axis of {axis_n} cells with {outer} x "
                         f"{inner} lines exceeds the kernel's 32-bit line "
                         f"indexing")
    return Launch(n, outer, split, inner, src, dst, axis_n, modes,
                  twiddle_store, cols, cols + 1, blocks, _smem(n, cols))


def axis_launches(outer: int, n: int, inner: int, modes: int = 0,
                  modes_in: bool = False, modes_out: bool = False):
    """The launches (one, or two for a split line) of the FFT along the
    axis of ``n`` fine cells of a grid seen as [outer, n, inner]: the
    input holds the axis' ``modes`` modes where ``modes_in`` (the rest of
    the line is zero), the output keeps only them where ``modes_out``.
    The first launch of a split writes a dense [outer, n, inner] scratch
    grid that the second reads."""
    src = Side(modes if modes_in else n, modes_in, 1, 0)
    dst = Side(modes if modes_out else n, modes_out, 1, 0)
    split = split_of(n)
    if split is None:
        return (_launch(n, outer, 1, inner, src, dst, n, modes, False),)
    n1, n2 = split
    return (_launch(n1, outer, n2, inner, src._replace(step=n2,
                                                       split_step=1),
                    Side(n, False, n2, 1), n, modes, True),
            _launch(n2, outer, n1, inner, Side(n, False, 1, n2),
                    dst._replace(step=n1, split_step=1), n, modes, False))


def fft_params(launch: Launch, sign: int, load_weights: bool = False,
               store_weights: int = 0, wn=(1, 1, 1)):
    """The int parameter array of a launch, in the order of ``FftParam``
    in ``csrc/fft3d.cu``: ``load_weights`` (the modes-in side carries the
    weights of line (i, j) and mode k), ``store_weights`` (3 or 2: the
    modes-out side carries w0 w1 w2, or w0 w1), ``wn`` the mode counts
    (n0, n1, n2) that decode them."""
    rad = radices(launch.n)
    src, dst = launch.src, launch.dst
    ints = ((launch.n, launch.cols, launch.cols.bit_length() - 1,
             launch.pitch, sign, launch.blocks, launch.smem, launch.outer,
             launch.split, launch.inner, src.len, int(src.modes), src.step,
             src.split_step, dst.len, int(dst.modes), dst.step,
             dst.split_step, launch.axis_n, launch.modes,
             int(launch.twiddle_store), int(load_weights), store_weights)
            + tuple(wn) + (len(rad),) + rad
            + (0,) * (MAX_RADICES - len(rad)))
    return (ctypes.c_int * len(ints))(*ints)


def twiddle_table(n: int, sign: int) -> np.ndarray:
    """exp(sign 2 pi i m / n), m < n, computed in float64 and rounded
    once to complex64."""
    return np.exp(sign * 2j * np.pi * np.arange(n) / n).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _twiddles(n: int, sign: int, device) -> torch.Tensor:
    return torch.as_tensor(twiddle_table(n, sign), device=device)


def _sign(fft_direction: str) -> int:
    return -1 if fft_direction == "forward" else 1


def _run_axis(src: torch.Tensor, dst: torch.Tensor, launches, sign: int,
              weights=(None, None, None), load_weights: bool = False,
              store_weights: int = 0, wn=(1, 1, 1)) -> int:
    """Runs an axis' launches from ``src`` to ``dst`` (a split through a
    dense scratch grid); the weights go with the first launch's load and
    the last launch's store. Returns the number of launches."""
    lib, dev = _build.library(), src.device
    scratch = (torch.empty(launches[0].outer * launches[0].axis_n
                           * launches[0].inner, dtype=torch.complex64,
                           device=dev) if len(launches) == 2 else None)
    ptrs = [0 if w is None else w.data_ptr() for w in weights]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for i, launch in enumerate(launches):
            first, last = i == 0, i == len(launches) - 1
            a = src if first else scratch
            b = dst if last else scratch
            tw_long = (_twiddles(launch.axis_n, sign, dev).data_ptr()
                       if launch.twiddle_store else 0)
            rc = lib.tnt_fft_axis(
                a.data_ptr(), b.data_ptr(),
                _twiddles(launch.n, sign, dev).data_ptr(), tw_long, *ptrs,
                fft_params(launch, sign, load_weights and first,
                           store_weights if last else 0, wn), stream)
            _build.check(rc, "tnt_fft_axis launch")
    return len(launches)


def _weights3(plan, device):
    ws = [deconv_weights(plan, d, torch.float32, device) for d in range(3)]
    for d, w in enumerate(ws):
        _build.require_cuda("fft3d", w, f"w{d}", torch.float32,
                            (plan.grid_shape[d],))
    return ws


def _rank3(plan) -> None:
    if plan.rank != 3:
        raise NotImplementedError("the pruned FFT passes are rank 3 only")


def modes_to_fine_cuda(modes: torch.Tensor, plan) -> torch.Tensor:
    """Hopper ``fft_plain(amplify_pad_plain(modes, plan))``: float32
    planar modes [B, n0, n1, n2, 2] -> complex64 fine grid [B, nf0, nf1,
    nf2], in three pruned passes (axis 2: the B n0 n1 mode lines,
    weighted; axis 1: B n0 nf2 lines; axis 0: every line)."""
    _rank3(plan)
    batch = modes.shape[0]
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    _build.require_cuda("modes_to_fine", modes, "modes", torch.float32,
                        (batch, n0, n1, n2, 2))
    sign, dev = _sign(plan.spec.fft_direction), modes.device
    t1 = torch.empty((batch, n0, n1, f2), dtype=torch.complex64, device=dev)
    t2 = torch.empty((batch, n0, f1, f2), dtype=torch.complex64, device=dev)
    fine = torch.empty((batch, f0, f1, f2), dtype=torch.complex64,
                       device=dev)
    count = _run_axis(modes, t1, axis_launches(batch * n0 * n1, f2, 1, n2,
                                               modes_in=True),
                      sign, _weights3(plan, dev), load_weights=True,
                      wn=(n0, n1, n2))
    count += _run_axis(t1, t2, axis_launches(batch * n0, f1, f2, n1,
                                             modes_in=True), sign)
    count += _run_axis(t2, fine, axis_launches(batch, f0, f1 * f2, n0,
                                               modes_in=True), sign)
    modes_to_fine_cuda.launches += count
    return fine


def fine_to_modes_cuda(fine: torch.Tensor, plan, axes: int = 3
                       ) -> torch.Tensor:
    """Hopper ``truncate_deconvolve_plain(fft_plain(fine), plan, axes)``:
    complex64 fine grid [B, nf0, nf1, nf2] -> float32 planar modes
    [B, n0, n1, n2, 2] in three pruned passes (axis 2: every line, its n2
    modes kept; axis 1: B nf0 n2 lines, n1 kept; axis 0: B n1 n2 lines,
    n0 kept, weighted). ``axes=2``: the fused route's [B, nf0, nf1, n2],
    axes 1 and 0 only, with the weights of axes 0 and 1."""
    _rank3(plan)
    batch = fine.shape[0]
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    _build.require_cuda("fine_to_modes", fine, "fine grid", torch.complex64,
                        (batch, f0, f1, f2 if axes == 3 else n2))
    sign, dev = _sign(plan.spec.fft_direction), fine.device
    count = 0
    if axes == 3:
        t1 = torch.empty((batch, f0, f1, n2), dtype=torch.complex64,
                         device=dev)
        count += _run_axis(fine, t1, axis_launches(batch * f0 * f1, f2, 1,
                                                   n2, modes_out=True), sign)
        fine = t1
    t2 = torch.empty((batch, f0, n1, n2), dtype=torch.complex64, device=dev)
    out = torch.empty((batch, n0, n1, n2, 2), dtype=torch.float32,
                      device=dev)
    count += _run_axis(fine, t2, axis_launches(batch * f0, f1, n2, n1,
                                               modes_out=True), sign)
    count += _run_axis(t2, out, axis_launches(batch, f0, n1 * n2, n0,
                                              modes_out=True),
                       sign, _weights3(plan, dev), store_weights=axes,
                       wn=(n0, n1, n2))
    fine_to_modes_cuda.launches += count
    return out


def fft3d_cuda(x: torch.Tensor, dims, fft_direction: str) -> torch.Tensor:
    """Hopper ``fft_plain``, the kernel's full-grid mode: a contiguous
    complex64 CUDA tensor -> its unnormalized DFT over ``dims`` (last
    first), one launch per axis (two for a split line); the first writes
    a new tensor, the others run in place but for a split's second."""
    _build.require_cuda("fft3d", x, "grid", torch.complex64, x.shape)
    sign, src, out = _sign(fft_direction), x, torch.empty_like(x)
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        launches = axis_launches(int(np.prod(x.shape[:d], dtype=np.int64)),
                                 int(x.shape[d]),
                                 int(np.prod(x.shape[d + 1:],
                                             dtype=np.int64)))
        fft3d_cuda.launches += _run_axis(src, out, launches, sign)
        src = out
    return out


modes_to_fine_cuda.launches = 0
fine_to_modes_cuda.launches = 0
fft3d_cuda.launches = 0
