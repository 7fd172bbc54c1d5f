"""The work of a spread or an interp, counted from the problem alone, and
the least time an NVIDIA H100 could take for it.

A stage is given by its points M, rank d, mode grid, channels (two per
complex transform: re and im) and tolerance. The fine grid is the mode
grid upsampled twofold to the next 2-3-5-smooth size, and the kernel
width w = ceil(log10(1 / tol)) + 1 (FINUFFT's rule at upsampling 2).
Nothing here reads the program's tiles, slots, halos, chunk padding or
plan level, so any implementation is read against the same work.

- bytes: float32 coordinates (d per point) and point values (one per
  channel) read or written once, and the fine grid (one float32 per
  cell and channel) written (spread) or read (interp) once;
- operations: per point, a multiply-add (2 operations) per window cell
  and channel, and one multiply per window cell for the tensor product
  of the per-axis weights. The weights' own evaluation is left out: a
  plan may compute them ahead.

The least time is the larger of bytes / 3.35 TB/s and operations /
67 TFLOP/s (data sheet, H100 SXM, 700 W, float32 outside the tensor
cores); ``binds`` names the larger.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
F32_BYTES = 4
UPSAMPLING = 2.0


def smooth_up(n: int) -> int:
    """The least integer >= n whose prime factors are 2, 3 and 5."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def fine_shape(modes: Sequence[int]) -> Tuple[int, ...]:
    return tuple(smooth_up(math.ceil(UPSAMPLING * n)) for n in modes)


def kernel_width(tol: float) -> int:
    return math.ceil(math.log10(1.0 / tol) - 1e-9) + 1


@dataclasses.dataclass(frozen=True)
class Stage:
    """One spread or interp: ``kind`` "spread" (points to fine grid) or
    "interp" (fine grid to points)."""
    kind: str
    points: int
    modes: Tuple[int, ...]
    channels: int
    tol: float

    def work(self) -> Tuple[float, float]:
        """(bytes, float32 operations)."""
        rank = len(self.modes)
        cells = math.prod(fine_shape(self.modes))
        window = kernel_width(self.tol) ** rank
        nbytes = F32_BYTES * (self.channels * cells
                              + self.points * (rank + self.channels))
        ops = self.points * window * (2 * self.channels + 1)
        return float(nbytes), float(ops)


def least_time(stages: Iterable[Stage]) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time for all of
    ``stages``' work, and which bound binds."""
    nbytes = ops = 0.0
    for stage in stages:
        b, o = stage.work()
        nbytes, ops = nbytes + b, ops + o
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
