"""Options of the planar NUFFT.

The fields of ``tensorflow_nufft_tpu.options.Options`` that this port
reads, as a plain dataclass (no pydantic, no proto wire format yet).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class PointsRange(enum.IntEnum):
    """Supported range of the nonuniform points.

    - **STRICT**: only values in ``[-pi, pi]`` are supported.
    - **EXTENDED**: values in ``[-3*pi, 3*pi]`` are supported (default).
    - **INFINITE**: any value is supported.
    """
    STRICT = 0
    EXTENDED = 1
    INFINITE = 2


@dataclasses.dataclass
class Options:
    """Advanced options for ``planar.nufft`` and ``PlannedNufft``.

    Attributes:
        points_range: A ``PointsRange``; defaults to EXTENDED.
        upsampling_factor: Optional override of the fine-grid
            oversampling factor sigma (> 1.0); None selects
            automatically.
        kernel_evaluation_method: 'auto', 'direct' or 'horner'. 'auto'
            picks the fitted Horner polynomial for float32 plans and
            direct exp/sqrt for float64.
        max_batch_size: Optional int; larger inner batches run in
            chunks of this size.
        show_warnings: Warn when a tolerance below machine precision is
            clamped.
        verbosity: 0 = silent; 1 logs a one-line plan summary per
            transform to stderr.
    """
    points_range: PointsRange = PointsRange.EXTENDED
    upsampling_factor: Optional[float] = None
    kernel_evaluation_method: str = "auto"
    max_batch_size: Optional[int] = None
    show_warnings: bool = True
    verbosity: int = 0

    def __post_init__(self):
        self.points_range = PointsRange(self.points_range)
        if self.upsampling_factor is not None and \
                self.upsampling_factor <= 1.0:
            raise ValueError(
                f"upsampling_factor must be > 1.0, got "
                f"{self.upsampling_factor}")
        if self.kernel_evaluation_method not in ("auto", "direct",
                                                 "horner"):
            raise ValueError(
                f"kernel_evaluation_method must be one of 'auto', "
                f"'direct', 'horner', got "
                f"{self.kernel_evaluation_method!r}")
        if self.max_batch_size is not None and self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}")
        if self.verbosity < 0:
            raise ValueError(
                f"verbosity must be >= 0, got {self.verbosity}")
