"""Mode stages of the planar NUFFT: overlap-add/FFT/truncate/deconvolve
(type-1) and amplify/pad/FFT/halo windowing (type-2).

Counterpart of ``tensorflow_nufft_tpu.fft.planar_fft``
(``dft_truncate_deconvolve_tiled_xla``, ``amplify_pad_dft_tiled_xla``)
and ``fft.fft_ops``. The TPU path computes these stages as pruned matmul
DFTs because its backend has no complex FFT; here they are cuFFT (or
pocketfft on the CPU) through ``torch.fft``, on the full fine grid.

Conventions, as in the JAX package: 'forward' is the exp(-i k.x) sign,
'backward' exp(+i k.x) with no normalization; mode index i along a size-n
axis is frequency k = i - n//2 (CMCL order) and lives at fine-grid slot
k mod nf; the deconvolution weights are plan.deconv_weights cast once to
the working precision.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels.binning import (
    TileGeometry, extend_tiles, overlap_add)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _slots(n: int, nf: int, device) -> torch.Tensor:
    k = np.arange(n) - n // 2
    return torch.as_tensor(np.mod(k, nf), device=device)


def _deconv(plan, dim: int, dtype, device) -> torch.Tensor:
    w = plan.deconv_weights(dim).astype(_NP_DTYPE[dtype])
    return torch.as_tensor(w, device=device)


def _fft(x: torch.Tensor, fft_direction: str) -> torch.Tensor:
    dims = tuple(range(1, x.ndim))
    if fft_direction == "forward":
        return torch.fft.fftn(x, dim=dims)
    return torch.fft.ifftn(x, dim=dims, norm="forward")   # unnormalized


def _separable_weights(plan, dtype, device) -> torch.Tensor:
    """[n0, n1, ...] outer product of the per-axis deconvolution
    weights."""
    w = None
    for d in range(plan.rank):
        wd = _deconv(plan, d, dtype, device)
        w = wd if w is None else w[..., None] * wd
    return w


def dft_truncate_deconvolve_tiled(tiles: torch.Tensor, plan,
                                  geom: TileGeometry, batch: int
                                  ) -> torch.Tensor:
    """Type-1 post-stage: tiles [*tiles, 2*batch, *ext] (row order
    (b, re/im)) -> modes [batch, *grid_shape, 2]."""
    fine = overlap_add(tiles, geom)                    # [2B, *fine]
    fine = fine.reshape((batch, 2) + geom.fine_shape)
    spec = _fft(torch.complex(fine[:, 0], fine[:, 1]),
                plan.spec.fft_direction)
    for d in range(plan.rank):
        spec = spec.index_select(
            1 + d, _slots(plan.grid_shape[d], plan.fine_shape[d],
                          tiles.device))
    spec = spec * _separable_weights(plan, tiles.dtype, tiles.device)
    return torch.view_as_real(spec).contiguous()


def amplify_pad_dft_tiled(modes: torch.Tensor, plan, geom: TileGeometry
                          ) -> torch.Tensor:
    """Type-2 pre-stage: modes [batch, *grid_shape, 2] -> tiles
    [*tiles, 2*batch, *ext] ready for the interp kernel."""
    batch = modes.shape[0]
    z = torch.complex(modes[..., 0], modes[..., 1])
    z = z * _separable_weights(plan, modes.dtype, modes.device)
    fine = z.new_zeros((batch,) + tuple(plan.fine_shape))
    index = [slice(None)]
    for d in range(plan.rank):
        shape = [1] * plan.rank
        shape[d] = plan.grid_shape[d]
        index.append(_slots(plan.grid_shape[d], plan.fine_shape[d],
                            modes.device).reshape(shape))
    fine[tuple(index)] = z
    fine = torch.view_as_real(_fft(fine, plan.spec.fft_direction))
    fine = fine.movedim(-1, 1).reshape((2 * batch,) + geom.fine_shape)
    return extend_tiles(fine, geom)
