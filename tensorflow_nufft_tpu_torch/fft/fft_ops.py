"""FFT, deconvolution and amplification of the complex fine grid.

Counterpart of ``tensorflow_nufft_tpu.fft.fft_ops``, the mode stage of
the JAX package's XLA path (float64 and complex-dtype data), which the
port's float64 route runs (``kernels.dispatch.route``). The JAX package
runs it in XLA, so ``torch.fft`` serves it here.

Conventions: 'forward' is the exp(-i k.x) sign, 'backward' exp(+i k.x)
with no normalization; mode index i along a size-n axis is frequency
k = i - n//2 (CMCL order) and lives at fine-grid slot k mod nf.
"""

from __future__ import annotations

import torch

from tensorflow_nufft_tpu_torch.kernels import fft3d
from tensorflow_nufft_tpu_torch.kernels.mode3d import deconv_weights


def fft_fine(fine: torch.Tensor, rank: int, fft_direction: str
             ) -> torch.Tensor:
    """FFT over the trailing ``rank`` axes with the requested sign,
    unnormalized in both directions (``torch.fft``)."""
    return fft3d.fft_plain(fine, tuple(range(-rank, 0)), fft_direction)


def _weighted(x: torch.Tensor, plan) -> torch.Tensor:
    """``x`` [B, *grid_shape] times the separable deconvolution weights,
    one axis at a time."""
    for d in range(plan.rank):
        shape = [1] * x.ndim
        shape[1 + d] = plan.grid_shape[d]
        x = x * deconv_weights(plan, d, x.real.dtype, x.device).reshape(shape)
    return x


def deconvolve(fine_hat: torch.Tensor, plan) -> torch.Tensor:
    """Spectrum [B, *fine_shape] -> modes [B, *grid_shape] in CMCL order:
    truncation to the requested modes, then division by the kernel's
    Fourier series."""
    x = fine_hat
    for d in range(plan.rank):
        axis, n, nf = 1 + d, plan.grid_shape[d], plan.fine_shape[d]
        x = torch.cat([x.narrow(axis, nf - n // 2, n // 2),
                       x.narrow(axis, 0, n - n // 2)], dim=axis)
    return _weighted(x, plan)


def amplify(modes: torch.Tensor, plan) -> torch.Tensor:
    """Modes [B, *grid_shape] in CMCL order -> fine-grid spectrum
    [B, *fine_shape]: the modes times the deconvolution weights, zero
    outside the mode band."""
    x = _weighted(modes, plan)
    for d in range(plan.rank):
        axis, n, nf = 1 + d, plan.grid_shape[d], plan.fine_shape[d]
        pad = list(x.shape)
        pad[axis] = nf - n
        x = torch.cat([x.narrow(axis, n // 2, n - n // 2), x.new_zeros(pad),
                       x.narrow(axis, 0, n // 2)], dim=axis)
    return x
