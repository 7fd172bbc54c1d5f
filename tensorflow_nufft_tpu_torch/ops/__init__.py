"""Public NUFFT operations on complex tensors, with the core planar
pipeline and the batching helpers behind them."""

from tensorflow_nufft_tpu_torch.ops.nufft_ops import (
    nufft,
    interp,
    spread,
    nudft,
)

__all__ = ["nufft", "interp", "spread", "nudft"]
