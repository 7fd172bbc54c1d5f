"""Helpers of the public API: argument validation and NumPy-style
broadcasting of batch dims.

Counterpart of the helpers of ``tensorflow_nufft_tpu.ops.nufft_ops``.
Batch dims of ``source`` and ``points`` broadcast; dims in which the
points are broadcast (size 1) are "inner" dims vectorized into one core
call, the rest are "outer" dims, run by a Python loop (the JAX package
uses ``vmap``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.utils.batching import chunked_map

VALID_TRANSFORM_TYPES = ("type_1", "type_2")
VALID_FFT_DIRECTIONS = ("forward", "backward")


def _validate_enum(value, valid, name):
    if value not in valid:
        raise ValueError(
            f"Invalid {name}: {value!r}. Must be one of {sorted(valid)}.")
    return value


def _canonical_grid_shape(grid_shape) -> Tuple[int, ...]:
    if isinstance(grid_shape, (int, np.integer)):
        return (int(grid_shape),)
    return tuple(int(d) for d in np.asarray(grid_shape).reshape(-1))


def _broadcast_batch_shapes(a: Tuple[int, ...], b: Tuple[int, ...]
                            ) -> Tuple[int, ...]:
    try:
        return tuple(np.broadcast_shapes(a, b))
    except ValueError as err:
        raise ValueError(
            "Incompatible batch shapes for source and points. The batch "
            f"dimensions must be broadcastable. Received: {a}, {b}"
        ) from err


def _apply_batched(core_fn, source: torch.Tensor, points: torch.Tensor,
                   spec, elem_rank: int, out_elem_shape: Tuple[int, ...],
                   max_batch_size: Optional[int]) -> torch.Tensor:
    """Runs the inner-batched core over broadcast batch dims.

    Args:
        core_fn: callable (source[B, *elem], points[M, rank], spec) -> out.
        source: [*src_batch, *elem].
        points: [*pts_batch, M, rank].
        elem_rank: number of trailing element dims of source.
        out_elem_shape: trailing element shape of the output.

    Returns:
        [*broadcast_batch, *out_elem_shape]
    """
    num_points = points.shape[-2]
    rank = points.shape[-1]
    elem_shape = tuple(source.shape[source.ndim - elem_rank:])

    src_batch = tuple(source.shape[:source.ndim - elem_rank])
    pts_batch = tuple(points.shape[:-2])
    nb = max(len(src_batch), len(pts_batch))
    src_batch_p = (1,) * (nb - len(src_batch)) + src_batch
    pts_batch_p = (1,) * (nb - len(pts_batch)) + pts_batch
    batch = _broadcast_batch_shapes(src_batch_p, pts_batch_p)

    inner_dims = [i for i in range(nb) if pts_batch_p[i] == 1]
    outer_dims = [i for i in range(nb) if pts_batch_p[i] != 1]
    inner_shape = tuple(batch[i] for i in inner_dims)
    outer_shape = tuple(batch[i] for i in outer_dims)
    inner_size = int(np.prod(inner_shape, dtype=np.int64))
    outer_size = int(np.prod(outer_shape, dtype=np.int64))

    # Bring source to [*outer, *inner, *elem] then flatten.
    source_b = source.reshape(src_batch_p + elem_shape).expand(
        batch + elem_shape)
    perm = outer_dims + inner_dims + list(range(nb, nb + elem_rank))
    source_flat = source_b.permute(perm).reshape(
        (outer_size, inner_size) + elem_shape)

    # Bring points to [*outer, M, rank] then flatten outer.
    pts_perm = outer_dims + inner_dims + [nb, nb + 1]
    points_flat = points.reshape(pts_batch_p + (num_points, rank)).permute(
        pts_perm).reshape((outer_size, num_points, rank))

    def run_inner(src_i, pts_i):
        if max_batch_size is not None and inner_size > max_batch_size:
            return chunked_map(lambda s: core_fn(s, pts_i, spec),
                               src_i, max_batch_size)
        return core_fn(src_i, pts_i, spec)

    out = torch.stack([run_inner(source_flat[i], points_flat[i])
                       for i in range(outer_size)])
    out = out.reshape(outer_shape + inner_shape + out_elem_shape)
    # Invert the batch-dim permutation.
    inv = [0] * nb
    for pos, dim in enumerate(outer_dims + inner_dims):
        inv[dim] = pos
    out = out.permute(inv + list(range(nb, nb + len(out_elem_shape))))
    return out.reshape(batch + out_elem_shape)
