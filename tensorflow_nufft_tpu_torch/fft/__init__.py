"""Mode stages of the planar NUFFT (the FFT kernel at rank 3 on the card,
``torch.fft`` elsewhere)."""
