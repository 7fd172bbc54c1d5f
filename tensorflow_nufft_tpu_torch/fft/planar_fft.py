"""Mode stages of the planar NUFFT: overlap-add/FFT/truncate/deconvolve
(type-1) and amplify/pad/FFT/halo windowing (type-2).

Counterpart of ``tensorflow_nufft_tpu.fft.planar_fft``
(``dft_truncate_deconvolve_tiled``, ``amplify_pad_dft_tiled``) and
``fft.fft_ops``. The TPU path computes these stages as pruned matmul
DFTs because its backend has no complex FFT. Here, at rank 3 on the card,
they are the halo kernels of ``kernels.mode3d`` around the pruned FFT
passes of ``kernels.fft3d`` (``modes_to_fine_cuda``,
``fine_to_modes_cuda``), which fuse the amplification and padding, or
the truncation and deconvolution, into their first load or last store;
elsewhere the plain versions, an FFT of the full fine grid
(``torch.fft``).

``spread_dft_fused`` is the planned type-1 of ``kernels.pallas_dft.
spread_dft_fused``: at the rank-3 binned level with a band, where the
``FUSED_DFTA`` gate takes it, the fused route, the banded spread whose
epilogue contracts axis 2 with the twiddles of ``dfta_twiddles``
(``kernels.dispatch.spread_dfta``), then the two-axis fold and the
pruned passes of axes 1 and 0; elsewhere the spread and the staged mode
stage above.

The steps dispatch as the JAX rank-3 stages do (``planar_fft.py:143-150``,
``:244-250``): at rank 3 a CUDA tensor goes to the hand-written kernels;
a CPU tensor, and ranks 1 and 2 (which the JAX package keeps in XLA), to
their plain PyTorch versions.

Conventions, as in the JAX package: 'forward' is the exp(-i k.x) sign,
'backward' exp(+i k.x) with no normalization; mode index i along a size-n
axis is frequency k = i - n//2 (CMCL order) and lives at fine-grid slot
k mod nf; the deconvolution weights are plan.deconv_weights cast once to
the working precision.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.fft.fft_ops import fft_fine
from tensorflow_nufft_tpu_torch.kernels import dispatch, fft3d, mode3d
from tensorflow_nufft_tpu_torch.kernels.binning import (
    BandInfo, BinnedPoints, KernelWeights, TileGeometry)
from tensorflow_nufft_tpu_torch.ops.nufft_ops import _full_precision_matmul
from tensorflow_nufft_tpu_torch.plan.plan import make_plan
from tensorflow_nufft_tpu_torch.utils import profiling as prof

# The planned rank-3 type-1 with a band takes the fused route (the banded
# spread with the axis-2 DFT epilogue, then a two-axis mode stage) when
# True, the banded spread and the three-axis stage when False. The staged
# route is the default: it was the faster at the 3D headline on an H100
# (chip_smoke.py's route phase; the times are in PERF.md). The fused route
# keeps the tile array and the full fine grid out of device memory (y is
# 107 MB per transform there, the tile array and grid 375 MB), for a
# caller who needs that memory more than the time.
FUSED_DFTA = False


def _dims(x: torch.Tensor):
    """Every axis but the batch axis."""
    return tuple(range(1, x.ndim))


def dft_truncate_deconvolve_tiled(tiles: torch.Tensor, plan,
                                  geom: TileGeometry, batch: int
                                  ) -> torch.Tensor:
    """Type-1 post-stage: tiles [*tiles, 2*batch, *ext] (row order
    (b, re/im)) -> modes [batch, *grid_shape, 2]."""
    if mode3d.on_kernels(tiles, plan.rank):
        return fft3d.fine_to_modes_cuda(
            mode3d.fold3d_cuda(tiles, geom, batch), plan)
    fine = mode3d.fold_plain(tiles, geom, batch)
    return mode3d.truncate_deconvolve_plain(
        fft3d.fft_plain(fine, _dims(fine), plan.spec.fft_direction), plan)


def amplify_pad_dft_tiled(modes: torch.Tensor, plan, geom: TileGeometry
                          ) -> torch.Tensor:
    """Type-2 pre-stage: modes [batch, *grid_shape, 2] -> tiles
    [*tiles, 2*batch, *ext] ready for the interp kernel."""
    if mode3d.on_kernels(modes, plan.rank):
        return mode3d.extend_tiles3d_cuda(
            fft3d.modes_to_fine_cuda(modes, plan), geom)
    fine = mode3d.amplify_pad_plain(modes, plan)
    return mode3d.extend_plain(
        fft3d.fft_plain(fine, _dims(fine), plan.spec.fft_direction), geom)


def _mode_twiddles(nf: int, n: int, sign: float, weights: np.ndarray,
                   truncating: bool) -> tuple:
    """The port's copy of the JAX package's ``fft.planar_fft.
    _mode_twiddles``: pruned, weighted DFT matrices that fuse the
    deconvolution (or amplification) into the DFT of one axis. Mode i
    (CMCL order, k = i - n//2) lives at fine-grid slot k mod nf. With
    ``truncating`` (type-1) (C, S) of shape [nf, n], C[l, i] = w[i]
    cos(2 pi l slot_i / nf) and S[l, i] = sign w[i] sin(...); otherwise
    the transposed [n, nf] layout. Float64."""
    k = np.arange(n) - n // 2
    slots = np.mod(k, nf)
    ang = (2.0 * np.pi / nf) * np.outer(np.arange(nf), slots)  # [nf, n]
    c = np.cos(ang) * weights[None, :]
    s = sign * np.sin(ang) * weights[None, :]
    if truncating:
        return c, s
    return c.T.copy(), s.T.copy()


def _contract_planar(xr: torch.Tensor, xi: torch.Tensor, c: torch.Tensor,
                     s: torch.Tensor, axis: int):
    """(xr + i xi) contracted along ``axis`` with (c + i s); returns the
    planar pair with the transformed axis in place (the JAX package's
    ``_contract_planar``, an XLA ``tensordot`` at HIGHEST precision:
    full float32 here, TF32 off)."""
    with _full_precision_matmul():
        ar = torch.tensordot(xr, c, dims=([axis], [0]))
        br = torch.tensordot(xr, s, dims=([axis], [0]))
        ai = torch.tensordot(xi, c, dims=([axis], [0]))
        bi = torch.tensordot(xi, s, dims=([axis], [0]))
    return (ar - bi).movedim(-1, axis), (ai + br).movedim(-1, axis)


def ext_mode_twiddles(nf: int, n: int, num_tiles: int, tile: int,
                      pad: int, sign: float, weights: np.ndarray):
    """The port's copy of the JAX package's
    ``fft.planar_fft._ext_mode_twiddles`` (truncating form): [nt*E, n]
    cos and sin matrices over the tile-extended axis, row (ti, e) the
    fine index g = (ti*tile + e - pad) mod nf, times the deconvolution
    weights, so that contracting extended rows with them does the
    overlap-add, DFT, truncation and deconvolution of that axis."""
    k = np.arange(n) - n // 2
    slots = np.mod(k, nf)
    ti = np.repeat(np.arange(num_tiles), tile + 2 * pad)
    e = np.tile(np.arange(tile + 2 * pad), num_tiles)
    g = np.mod(ti * tile + e - pad, nf)                  # [nt*E]
    ang = (2.0 * np.pi / nf) * np.outer(g, slots)        # [nt*E, n]
    return (np.cos(ang) * weights[None, :],
            sign * np.sin(ang) * weights[None, :])


@functools.lru_cache(maxsize=16)
def _dfta_twiddles(spec, geom: TileGeometry, device) -> torch.Tensor:
    plan = make_plan(spec)
    sign = -1.0 if spec.fft_direction == "forward" else 1.0
    c, s = ext_mode_twiddles(plan.fine_shape[2], plan.grid_shape[2],
                             geom.tiles[2], geom.tile[2], geom.pad, sign,
                             plan.deconv_weights(2))
    shape = (geom.tiles[2], geom.ext[2], plan.grid_shape[2])
    return torch.as_tensor(np.stack([m.reshape(shape).astype(np.float32)
                                     for m in (c, s - c, s + c)]),
                           device=device)


def dfta_twiddles(plan, geom: TileGeometry, device) -> torch.Tensor:
    """[3, nt2, E2, n2] float32 (c, s - c, s + c) axis-2 twiddles of the
    fused epilogue, as the JAX package's ``pallas_dft._twiddle_statics``
    builds its pass-A triple (float64, cast once); cached per plan spec,
    geometry and device."""
    return _dfta_twiddles(plan.spec, geom, torch.device(device))


def fused_route(geom: TileGeometry, band: Optional[BandInfo]) -> bool:
    """Whether a planned type-1 takes the fused route: rank 3 with an
    active band, and the ``FUSED_DFTA`` gate."""
    return FUSED_DFTA and band is not None and geom.rank == 3


def dft_truncate_deconvolve_fused(y: torch.Tensor, plan,
                                  geom: TileGeometry, batch: int
                                  ) -> torch.Tensor:
    """The fused route's mode stage: y [nt0, nt1, 2*batch, E0, E1, n2]
    (axis 2 already transformed, truncated and deconvolved) -> modes
    [batch, *grid_shape, 2]."""
    if y.is_cuda:
        return fft3d.fine_to_modes_cuda(mode3d.fold2_cuda(y, geom, batch),
                                        plan, axes=2)
    spec = fft3d.fft_plain(mode3d.fold_plain(y, geom, batch, axes=2), (1, 2),
                           plan.spec.fft_direction)
    return mode3d.truncate_deconvolve_plain(spec, plan, axes=2)


def spread_dft_fused(values_pl: torch.Tensor, binned: BinnedPoints,
                     geom: TileGeometry, plan, batch: int,
                     kw: Optional[KernelWeights] = None,
                     coords: Optional[torch.Tensor] = None,
                     band: Optional[BandInfo] = None) -> torch.Tensor:
    """Planned type-1 from slot-order values [2*batch, num_slots] (zero
    in padded slots) -> modes [batch, *grid_shape, 2]: the fused route
    where ``fused_route`` says so, else the spread and the staged mode
    stage. Either route runs its two steps under the ``nufft.spread`` and
    ``nufft.mode_dft_deconvolve`` spans."""
    if fused_route(geom, band):
        with prof.scope("nufft.spread"):
            y = dispatch.spread_dfta(values_pl, binned, geom, plan, coords,
                                     band, dfta_twiddles(plan, geom,
                                                         values_pl.device))
        with prof.scope("nufft.mode_dft_deconvolve"):
            return dft_truncate_deconvolve_fused(y, plan, geom, batch)
    with prof.scope("nufft.spread"):
        tiles = dispatch.spread_tiled(None, binned, geom, plan, kw=kw,
                                      coords=coords, band=band,
                                      values_slots=values_pl)
    with prof.scope("nufft.mode_dft_deconvolve"):
        return dft_truncate_deconvolve_tiled(tiles, plan, geom, batch)


def _complex(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(x.contiguous())


def dft_planar(x: torch.Tensor, rank: int, fft_direction: str
               ) -> torch.Tensor:
    """DFT over the ``rank`` spatial axes of a planar tensor [B, *spatial,
    2]: 'forward' exp(-i...), 'backward' exp(+i...), unnormalized. The
    JAX package's ``dft_planar`` is an XLA contraction; ``torch.fft``
    serves it here."""
    return torch.view_as_real(fft_fine(_complex(x), rank, fft_direction))


def dft_doubled_planar(x: torch.Tensor, rank: int, forward: bool
                       ) -> torch.Tensor:
    """DFT between N-support and the 2N torus, per spatial axis.

    forward=True: [B, *N, 2] -> [B, *2N, 2], the 2N-point forward DFT of
    the zero-padded input. forward=False: [B, *2N, 2] -> [B, *N, 2], the
    unnormalized inverse cropped to the leading N samples per axis (fold
    the 1/(2N)^rank into the spectrum applied between the two). The
    wings of ``planar.ToeplitzNormal``; the JAX package's
    ``dft_doubled_planar`` contracts with [N, 2N] twiddle matrices.
    """
    dims = tuple(range(1, 1 + rank))
    z = _complex(x)
    if forward:
        return torch.view_as_real(torch.fft.fftn(
            z, s=[2 * z.shape[d] for d in dims], dim=dims))
    out = torch.fft.ifftn(z, dim=dims, norm="forward")
    for d in dims:
        out = out.narrow(d, 0, z.shape[d] // 2)
    return torch.view_as_real(out)
