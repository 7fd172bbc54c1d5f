"""User-facing options."""

from tensorflow_nufft_tpu_torch.options.options import (
    DebuggingOptions,
    FftwOptions,
    FftwPlanningRigor,
    Options,
    PointsRange,
)

__all__ = ["Options", "DebuggingOptions", "FftwOptions",
           "FftwPlanningRigor", "PointsRange"]
