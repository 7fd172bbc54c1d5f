"""Mode stages of the planar NUFFT (cuFFT through ``torch.fft``)."""
