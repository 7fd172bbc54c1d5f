"""Mode stages around the FFT: the halo fold (type-1) and the halo
windows (type-2), and the plain versions of the whole stages.

Counterpart of the rank-3 ``tensorflow_nufft_tpu.kernels.pallas_dft``
pass chains. The TPU computes the mode-stage DFT as matrix products
with the halo fold, padding and weights built in; here the DFT, with the
amplification and padding (type-2) or the truncation and deconvolution
(type-1) fused into its first load or last store, is the hand-written
FFT of ``kernels.fft3d``, and the halo steps are hand-written Hopper
kernels of ``csrc/mode3d.cu``, one per entry point:

- ``fold3d_cuda`` (before ``fft3d.fine_to_modes_cuda``) replaces the
  halo fold of the type-1 passes ``_pass_a_kernel``, ``_pass_b_kernel``
  and ``_pass_c_kernel``;
- ``extend_tiles3d_cuda`` (after ``fft3d.modes_to_fine_cuda``) the halo
  windows of the type-2 passes ``_dual_c_kernel``, ``_dual_b_kernel``
  and ``_dual_a_kernel``;
- ``fold2_cuda``, the two-axis fold, that of passes ``_pass_b_kernel``
  and ``_pass_c_kernel`` on the fused type-1 route
  (``pallas_dft._run_passes_bc``), after the banded spread whose
  epilogue contracted axis 2 (``spread.spread_dfta_cuda``): it folds
  axes 0 and 1 of y [nt0, nt1, B2, E0, E1, n2].

The kernels take rank 3 and float32. Each has a plain PyTorch version of
the same function (any rank, float32 or float64): ``fold_plain`` (with
``axes=2`` for the two-axis fold) and ``extend_plain``; the plain mode
ends ``truncate_deconvolve_plain`` and ``amplify_pad_plain`` are those
of ``kernels.fft3d``'s passes. ``fft.planar_fft`` uses the plain
versions for CPU tensors and for ranks 1 and 2 (which the JAX package
also keeps out of Pallas), and ``chip_smoke.py`` holds each kernel to its
plain version on the card. Each CUDA entry point counts its launches in
its ``launches`` attribute. What bounds the kernels (memory traffic) is
in the source note of ``csrc/mode3d.cu``. They take rows of the tiles in
blocks of ``halo_launch``'s shape, computed here so that a CPU test can
sweep every geometry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import _build
from tensorflow_nufft_tpu_torch.kernels.binning import (
    TileGeometry, extend_tiles, overlap_add)
from tensorflow_nufft_tpu_torch.plan.plan import make_plan

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# The mode-stage constants are cached on their device per grid: built on
# the host and copied in every call, the 2^20 modes of the 1D headline
# made the planned transforms about 5x slower on an H100 (PERF.md). The
# cached tensors are read only.
@functools.lru_cache(maxsize=32)
def mode_slots(n: int, nf: int, device) -> torch.Tensor:
    """Fine-grid slot (i - n//2) mod nf of each CMCL mode index i."""
    k = np.arange(n) - n // 2
    return torch.as_tensor(np.mod(k, nf), device=device)


def deconv_weights(plan, dim: int, dtype, device) -> torch.Tensor:
    """The plan's deconvolution weights of axis ``dim``, cast once to
    the working precision."""
    return _deconv_weights(plan.spec, dim, dtype, torch.device(device))


@functools.lru_cache(maxsize=32)
def _deconv_weights(spec, dim: int, dtype, device) -> torch.Tensor:
    w = make_plan(spec).deconv_weights(dim).astype(_NP_DTYPE[dtype])
    return torch.as_tensor(w, device=device)


def _separable_weights(plan, dtype, device, axes=None) -> torch.Tensor:
    """[n0, n1, ...] outer product of the per-axis deconvolution
    weights of the first ``axes`` axes (all by default), in the kernels'
    product order ((w0 * w1) * w2)."""
    w = None
    for d in range(axes or plan.rank):
        wd = deconv_weights(plan, d, dtype, device)
        w = wd if w is None else w[..., None] * wd
    return w


def on_kernels(x: torch.Tensor, rank: int) -> bool:
    """Whether a mode-stage step on ``x`` runs the Hopper kernels: rank 3
    on the card (ranks 1 and 2 stay in plain torch, as the JAX package
    keeps them in XLA)."""
    return x.is_cuda and rank == 3


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any rank)
# ---------------------------------------------------------------------------

def fold_plain(tiles: torch.Tensor, geom: TileGeometry, batch: int,
               axes=None) -> torch.Tensor:
    """Tiles [*tiles, 2*batch, *ext] (row order (b, re/im)) -> complex
    fine grid [batch, *fine]: the periodic overlap-add of the halos.
    ``axes=2``: y [nt0, nt1, 2*batch, E0, E1, n2] -> [batch, nf0, nf1,
    n2], axis 2 untiled."""
    fine = overlap_add(tiles, geom, axes)
    fine = fine.reshape((batch, 2) + tuple(fine.shape[1:]))
    return torch.complex(fine[:, 0], fine[:, 1])


def truncate_deconvolve_plain(spec: torch.Tensor, plan, axes=None
                              ) -> torch.Tensor:
    """Complex spectrum [batch, *fine] -> planar modes
    [batch, *grid_shape, 2]: the spectrum at the mode slots, times the
    separable deconvolution weights. ``axes=2``: only axes 0 and 1 (the
    input's axis 2 already holds its modes, weighted)."""
    real = spec.real.dtype
    axes = axes or plan.rank
    for d in range(axes):
        spec = spec.index_select(
            1 + d, mode_slots(plan.grid_shape[d], plan.fine_shape[d],
                              spec.device))
    w = _separable_weights(plan, real, spec.device, axes)
    spec = spec * w.reshape(w.shape + (1,) * (plan.rank - axes))
    return torch.view_as_real(spec).contiguous()


def amplify_pad_plain(modes: torch.Tensor, plan) -> torch.Tensor:
    """Planar modes [batch, *grid_shape, 2] -> complex fine grid
    [batch, *fine]: the weighted modes at their slots, zero elsewhere."""
    batch = modes.shape[0]
    z = torch.complex(modes[..., 0], modes[..., 1])
    z = z * _separable_weights(plan, modes.dtype, modes.device)
    fine = z.new_zeros((batch,) + tuple(plan.fine_shape))
    index = [slice(None)]
    for d in range(plan.rank):
        shape = [1] * plan.rank
        shape[d] = plan.grid_shape[d]
        index.append(mode_slots(plan.grid_shape[d], plan.fine_shape[d],
                                modes.device).reshape(shape))
    fine[tuple(index)] = z
    return fine


def extend_plain(fine: torch.Tensor, geom: TileGeometry) -> torch.Tensor:
    """Complex fine grid [batch, *fine] -> tiles [*tiles, 2*batch, *ext]
    with periodic halos (channel 2b the real part, 2b + 1 the
    imaginary)."""
    batch = fine.shape[0]
    x = torch.view_as_real(fine).movedim(-1, 1)
    return extend_tiles(x.reshape((2 * batch,) + geom.fine_shape), geom)


# ---------------------------------------------------------------------------
# Hopper kernels (rank 3, float32)
# ---------------------------------------------------------------------------

def _run(name: str, *args) -> None:
    lib = _build.library()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*ptrs, stream)
    _build.check(rc, f"{name} launch")


# The halo kernels' blocks (csrc/mode3d.cu, __launch_bounds__(256)): at
# most HALO_THREADS threads, each stepping over up to HALO_ITERS rows,
# and at least HALO_BLOCKS blocks where the rows allow it (the H100's 132
# SMs, 8 blocks of 256 threads each).
HALO_THREADS = 256
HALO_ITERS = 2
HALO_BLOCKS = 132 * 8


def halo_launch(geom: TileGeometry, batch: int, kind: str, axes: int = 3,
                aligned: bool = True):
    """(vec, lanes, rows, iters, blocks) of an ``extend_tiles3d``
    (``kind`` "extend") or ``fold3d`` ("fold") launch on ``geom`` with
    ``batch`` batch elements and ``axes`` tiled axes (2: the fused
    route's y, axis 2 one untiled block of ``geom.tile[2]`` with no
    halo).

    A block is ``lanes`` x ``rows`` threads. Each lane moves ``vec``
    consecutive cells of axis 2 (4 where the axis-2 tile and halo are
    multiples of 4 and both tensors are 16-byte ``aligned``, so that a
    quad is one float4 and never straddles the periodic wrap; else 1),
    each row of threads one row of the flat row space (tile, batch
    element, axis 0, axis 1): the extended rows for "extend", the core
    rows for "fold". A block takes ``rows * iters`` consecutive rows;
    ``blocks`` cover them all."""
    pad2 = geom.pad if axes == 3 else 0
    t0, t1, t2 = geom.tile
    vec = 4 if aligned and t2 % 4 == 0 and pad2 % 4 == 0 else 1
    if kind == "extend":
        width = t2 + 2 * pad2
        per_tile = (t0 + 2 * geom.pad) * (t1 + 2 * geom.pad)
    else:
        width, per_tile = t2, t0 * t1
    lanes = min(width // vec, HALO_THREADS)
    rows = HALO_THREADS // lanes
    total = geom.num_tiles * batch * per_tile
    if total >= 2 ** 31:
        raise ValueError(f"{total} rows of tiles: the halo kernels index "
                         f"rows in 32 bits")
    iters = max(1, min(HALO_ITERS, total // (rows * HALO_BLOCKS)))
    return vec, lanes, rows, iters, -(-total // (rows * iters))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _rank3(kernel: str, geom: TileGeometry) -> None:
    if geom.rank != 3:
        raise NotImplementedError(f"the {kernel} kernel is rank 3 only")


def fold3d_cuda(tiles: torch.Tensor, geom: TileGeometry, batch: int
                ) -> torch.Tensor:
    """Hopper ``fold_plain``: tiles [*tiles, 2*batch, *ext] float32 ->
    complex64 fine grid [batch, *fine]."""
    _rank3("fold3d", geom)
    _build.require_cuda("fold3d", tiles, "tiles", torch.float32,
                        geom.tiles + (2 * batch,) + geom.ext)
    fine = torch.empty((batch,) + geom.fine_shape, dtype=torch.complex64,
                       device=tiles.device)
    launch = halo_launch(geom, batch, "fold", 3, _aligned(tiles, fine))
    _run("tnt_fold3d", tiles, fine,
         _build.mode_params(geom, batch, 3, launch))
    fold3d_cuda.launches += 1
    return fine


def extend_tiles3d_cuda(fine: torch.Tensor, geom: TileGeometry
                        ) -> torch.Tensor:
    """Hopper ``extend_plain``: complex64 fine grid [batch, *fine] ->
    float32 tiles [*tiles, 2*batch, *ext]."""
    _rank3("extend_tiles3d", geom)
    batch = fine.shape[0]
    _build.require_cuda("extend_tiles3d", fine, "fine grid",
                        torch.complex64, (batch,) + geom.fine_shape)
    tiles = torch.empty(geom.tiles + (2 * batch,) + geom.ext,
                        dtype=torch.float32, device=fine.device)
    launch = halo_launch(geom, batch, "extend", 3, _aligned(fine, tiles))
    _run("tnt_extend_tiles3d", fine, tiles,
         _build.mode_params(geom, batch, 3, launch))
    extend_tiles3d_cuda.launches += 1
    return tiles


def _modes2_geometry(geom: TileGeometry, n2: int) -> TileGeometry:
    """The fused route's y as a tiling: axes 0 and 1 as ``geom``'s, axis
    2 one untiled block of its n2 modes."""
    return TileGeometry(geom.fine_shape[:2] + (n2,), geom.tile[:2] + (n2,),
                        geom.pad, geom.chunk, geom.num_chunks)


def fold2_cuda(y: torch.Tensor, geom: TileGeometry, batch: int
               ) -> torch.Tensor:
    """Hopper ``fold_plain(axes=2)``: y [nt0, nt1, 2*batch, E0, E1, n2]
    float32 -> complex64 [batch, nf0, nf1, n2]."""
    _rank3("fold2", geom)
    n2 = y.shape[-1]
    _build.require_cuda("fold2", y, "y", torch.float32,
                        geom.tiles[:2] + (2 * batch,) + geom.ext[:2]
                        + (n2,))
    g2 = _modes2_geometry(geom, n2)
    fine = torch.empty((batch,) + g2.fine_shape, dtype=torch.complex64,
                       device=y.device)
    launch = halo_launch(g2, batch, "fold", 2, _aligned(y, fine))
    _run("tnt_fold3d", y, fine,
         _build.mode_params(g2, batch, 2, launch))
    fold2_cuda.launches += 1
    return fine


fold3d_cuda.launches = 0
fold2_cuda.launches = 0
extend_tiles3d_cuda.launches = 0
