"""Mode stages of the planar NUFFT (the FFT kernel at rank 3 on the card,
``torch.fft`` elsewhere), and the FFT stage of the XLA path's
counterpart: FFT on the fine grid plus deconvolution/amplification."""

from tensorflow_nufft_tpu_torch.fft.fft_ops import (
    fft_fine,
    deconvolve,
    amplify,
)

__all__ = ["fft_fine", "deconvolve", "amplify"]
