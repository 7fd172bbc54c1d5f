"""User-facing options."""

from tensorflow_nufft_tpu_torch.options.options import Options, PointsRange

__all__ = ["Options", "PointsRange"]
