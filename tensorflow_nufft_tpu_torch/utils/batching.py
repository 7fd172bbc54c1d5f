"""Leading-axis chunked mapping (the ``max_batch_size`` idiom).

Counterpart of ``tensorflow_nufft_tpu.utils.batching``: the inner batch
runs ``chunk`` transforms at a time so only one chunk's fine grids are
alive. PyTorch runs eagerly, so a Python loop replaces ``lax.map`` and
no padding is needed.
"""

from __future__ import annotations

from typing import Callable

import torch


def chunked_map(fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Applies ``fn`` ([n, ...] -> [n, ...]) over the leading axis of
    ``x`` in pieces of at most ``chunk`` rows and concatenates."""
    if x.shape[0] <= chunk:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk])
                      for i in range(0, x.shape[0], chunk)], dim=0)
