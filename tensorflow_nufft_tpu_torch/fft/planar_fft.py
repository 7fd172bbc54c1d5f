"""Mode stages of the planar NUFFT: overlap-add/FFT/truncate/deconvolve
(type-1) and amplify/pad/FFT/halo windowing (type-2).

Counterpart of ``tensorflow_nufft_tpu.fft.planar_fft``
(``dft_truncate_deconvolve_tiled``, ``amplify_pad_dft_tiled``) and
``fft.fft_ops``. The TPU path computes these stages as pruned matmul
DFTs because its backend has no complex FFT; here the DFT is cuFFT (or
pocketfft on the CPU) through ``torch.fft``, on the full fine grid.

The steps around the FFT dispatch as the JAX rank-3 stages do
(``planar_fft.py:143-150``, ``:244-250``): at rank 3 a CUDA tensor goes
to the hand-written kernels of ``kernels.mode3d``; a CPU tensor, and
rank 2 (which the JAX package keeps in XLA), to their plain PyTorch
versions.

Conventions, as in the JAX package: 'forward' is the exp(-i k.x) sign,
'backward' exp(+i k.x) with no normalization; mode index i along a size-n
axis is frequency k = i - n//2 (CMCL order) and lives at fine-grid slot
k mod nf; the deconvolution weights are plan.deconv_weights cast once to
the working precision.
"""

from __future__ import annotations

import torch

from tensorflow_nufft_tpu_torch.kernels import mode3d
from tensorflow_nufft_tpu_torch.kernels.binning import TileGeometry


def _fft(x: torch.Tensor, fft_direction: str) -> torch.Tensor:
    dims = tuple(range(1, x.ndim))
    if fft_direction == "forward":
        return torch.fft.fftn(x, dim=dims)
    return torch.fft.ifftn(x, dim=dims, norm="forward")   # unnormalized


def dft_truncate_deconvolve_tiled(tiles: torch.Tensor, plan,
                                  geom: TileGeometry, batch: int
                                  ) -> torch.Tensor:
    """Type-1 post-stage: tiles [*tiles, 2*batch, *ext] (row order
    (b, re/im)) -> modes [batch, *grid_shape, 2]."""
    if mode3d.on_kernels(tiles, plan.rank):
        spec = _fft(mode3d.fold3d_cuda(tiles, geom, batch),
                    plan.spec.fft_direction)
        return mode3d.truncate_deconvolve3d_cuda(spec, plan, geom)
    spec = _fft(mode3d.fold_plain(tiles, geom, batch),
                plan.spec.fft_direction)
    return mode3d.truncate_deconvolve_plain(spec, plan)


def amplify_pad_dft_tiled(modes: torch.Tensor, plan, geom: TileGeometry
                          ) -> torch.Tensor:
    """Type-2 pre-stage: modes [batch, *grid_shape, 2] -> tiles
    [*tiles, 2*batch, *ext] ready for the interp kernel."""
    if mode3d.on_kernels(modes, plan.rank):
        fine = _fft(mode3d.amplify_pad3d_cuda(modes, plan, geom),
                    plan.spec.fft_direction)
        return mode3d.extend_tiles3d_cuda(fine, geom)
    fine = _fft(mode3d.amplify_pad_plain(modes, plan),
                plan.spec.fft_direction)
    return mode3d.extend_plain(fine, geom)
