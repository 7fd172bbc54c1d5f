"""Package metadata for tensorflow_nufft_tpu_torch.

The PyTorch port of tensorflow_nufft_tpu: the same planar NUFFT, with
hand-written CUDA kernels for NVIDIA Hopper in place of the Pallas TPU
kernels.
"""

__title__ = "tensorflow-nufft-tpu-torch"
__summary__ = (
    "PyTorch port of tensorflow-nufft-tpu: planar 2D NUFFT with "
    "hand-written CUDA spread/interp kernels for NVIDIA Hopper."
)
__version__ = "0.1.0"
