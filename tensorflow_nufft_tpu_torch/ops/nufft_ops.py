"""The complex API: ``nufft``, ``interp``, ``spread`` and ``nudft``,
with argument validation and NumPy-style broadcasting of batch dims.

Counterpart of ``tensorflow_nufft_tpu.ops.nufft_ops``, on complex64 and
complex128 tensors. Batch dims of ``source`` and ``points`` broadcast;
dims in which the points are broadcast (size 1) are "inner" dims
vectorized into one core call, the rest are "outer" dims, run by a
Python loop (the JAX package uses ``vmap``).

The entry points run where the planar ones do (``device=``; numpy input
goes to the CUDA card by default, see ``utils.dtypes.entry_tensors``).
A transform takes the route of ``kernels.dispatch.route``: complex64 on
the card runs the hand-written kernels through the planar core (its
output is the planar API's, bit for bit), complex128 on the card the
torch-op counterpart of the JAX package's XLA path, CPU tensors the
kernels' plain versions. Differentiable in ``source`` and ``points``
(``ops.core``: a complex source's gradient is the conjugate of JAX's).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.ops.core import nufft_core, spread_only_core
from tensorflow_nufft_tpu_torch.options.options import Options, PointsRange
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, auto_max_batch_size, log_plan_summary, warn_if_tol_clamped)
from tensorflow_nufft_tpu_torch.utils.batching import chunked_map
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    COMPLEX_DTYPES, dtype_name, entry_tensors, real_dtype)

VALID_TRANSFORM_TYPES = ("type_1", "type_2")
VALID_FFT_DIRECTIONS = ("forward", "backward")


def _validate_enum(value, valid, name):
    if name == "transform_type" and value == "type_3":
        # Type-3 takes two point sets rather than a grid shape, so it has
        # its own entry point (ops.type3).
        raise NotImplementedError(
            "type-3 transforms use a different signature; call "
            "tensorflow_nufft_tpu_torch.nufft_type3(source, points, "
            "target_points, ...) instead")
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


def _check_dtypes(source: torch.Tensor, points: torch.Tensor) -> None:
    if source.dtype not in COMPLEX_DTYPES:
        raise TypeError(
            f"source must be complex64 or complex128, got {source.dtype}.")
    expected = real_dtype(source.dtype)
    if points.dtype != expected:
        raise TypeError(
            f"points must have dtype {expected} (the real dtype of "
            f"source's {source.dtype}), got {points.dtype}.")


def _check_points(source: torch.Tensor, points: torch.Tensor) -> int:
    """Checks points' shape and device; returns the rank."""
    if points.ndim < 2:
        raise ValueError(
            f"points must have shape [..., M, rank], got "
            f"{tuple(points.shape)}.")
    rank = int(points.shape[-1])
    if rank not in (1, 2, 3):
        raise ValueError(f"rank (points.shape[-1]) must be 1, 2 or 3, "
                         f"got {rank}.")
    if source.device != points.device:
        raise ValueError(
            f"source and points must be on one device, got "
            f"{source.device} and {points.device}.")
    return rank


def _shapes(source, points, grid_shape, transform_type, rank):
    """(grid_shape, elem_rank, out_elem_shape) of a complex transform."""
    num_points = int(points.shape[-2])
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = _canonical_grid_shape(grid_shape)
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {grid_shape}")
        if source.ndim < 1 or int(source.shape[-1]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"source.shape[-1]={source.shape[-1] if source.ndim else None}"
                f" vs points.shape[-2]={num_points}.")
        return grid_shape, 1, grid_shape
    if source.ndim < rank:
        raise ValueError(
            f"source must have at least rank {rank} for a rank-{rank} "
            f"type-2 transform, got shape {tuple(source.shape)}.")
    return tuple(int(d) for d in source.shape[-rank:]), rank, (num_points,)


def nufft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          tol: float = 1e-6,
          options: Optional[Options] = None,
          device=None) -> torch.Tensor:
    """Non-uniform discrete Fourier transform via the NUFFT (rank 1, 2
    or 3).

    Args:
        source: complex64/complex128. Type-2: the grid
            ``[...] + grid_shape``; type-1: the point values ``[..., M]``.
        points: ``[..., M, rank]`` coordinates in radians, in [-pi, pi]
            (wider per ``options.points_range``), of the real dtype of
            ``source``. Batch dims broadcast against ``source``'s.
        grid_shape: the type-1 output grid shape (ignored for type-2).
        transform_type: "type_1" (nonuniform -> uniform) or "type_2".
        fft_direction: "forward" (exp(-i k.x)) or "backward".
        tol: requested relative precision.
        options: optional ``Options``.
        device: where to run. By default tensors stay where they are and
            numpy/list input goes to the CUDA card (raises without one).

    Returns:
        ``[..., M]`` (type-2) or ``[...] + grid_shape`` (type-1), batch
        dims broadcast; modes in CMCL order (index i is k = i - N//2).
    """
    options = options or Options()
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    source, points = entry_tensors(source, points, device=device)
    _check_dtypes(source, points)
    rank = _check_points(source, points)
    grid_shape, elem_rank, out_elem_shape = _shapes(
        source, points, grid_shape, transform_type, rank)
    if options.debugging.check_points_range:
        check_points_range(points, options)
    return _run(nufft_core, transform_type, fft_direction, False, source,
                points, grid_shape, elem_rank, out_elem_shape, tol, options)


def check_points_range(points: torch.Tensor, options: Options) -> None:
    """The points-range check (``options.debugging.check_points_range``):
    raises ``ValueError`` unless every coordinate lies inside the range
    of ``options.points_range``. The JAX package's
    ``_poison_if_out_of_range`` raises the same on concrete inputs and
    poisons traced outputs with NaN; PyTorch runs eagerly, so here it
    always raises."""
    if options.points_range == PointsRange.INFINITE:
        return
    bound = np.pi if options.points_range == PointsRange.STRICT \
        else 3 * np.pi
    if not bool(((points > -bound) & (points < bound)).all()):
        raise ValueError(
            f"points are not within the supported range "
            f"[-{bound / np.pi:g}*pi, {bound / np.pi:g}*pi]. "
            "Use a wider options.points_range or disable "
            "options.debugging.check_points_range.")


def interp(source, points, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Interpolates the grid ``source`` ``[...] + grid_shape`` (complex;
    even dims, at least twice the kernel width, 5-smooth) at ``points``
    ``[..., M, rank]`` with the ES kernel of ``tol``, scaled to unit
    kernel integral (no FFT stage). Returns ``[..., M]``."""
    return _spread_or_interp("type_2", source, points, None, tol, options,
                             device)


def spread(source, points, grid_shape, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Spreads point values ``source`` ``[..., M]`` (complex) onto the
    grid ``grid_shape``: the transpose of ``interp``, with its grid
    constraints. Returns ``[...] + grid_shape``."""
    return _spread_or_interp("type_1", source, points, grid_shape, tol,
                             options, device)


def _spread_or_interp(transform_type, source, points, grid_shape, tol,
                      options, device):
    options = options or Options()
    source, points = entry_tensors(source, points, device=device)
    _check_dtypes(source, points)
    rank = _check_points(source, points)
    grid_shape, elem_rank, out_elem_shape = _shapes(
        source, points, grid_shape, transform_type, rank)
    return _run(spread_only_core, transform_type, "forward", True, source,
                points, grid_shape, elem_rank, out_elem_shape, tol, options)


def _run(core_fn, transform_type, fft_direction, spread_only, source,
         points, grid_shape, elem_rank, out_elem_shape, tol, options
         ) -> torch.Tensor:
    """Plans and runs ``core_fn`` over the broadcast batch."""
    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=int(points.shape[-1]),
        grid_shape=grid_shape,
        dtype_name=dtype_name(source.dtype),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=spread_only,
        upsampling_factor=None if spread_only else options.upsampling_factor,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )
    warn_if_tol_clamped(tol, spec.dtype_name, options.show_warnings)
    log_plan_summary(spec, options.verbosity)
    max_bs = options.max_batch_size
    if max_bs is None:
        # The planar core's fine grids hold each complex transform as two
        # real channels, and its size guard counts them: chunk to that.
        max_bs = auto_max_batch_size(spec, channels_per_batch=2)
    return _apply_batched(core_fn, source, points, spec, elem_rank,
                          out_elem_shape, max_bs)


def nudft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          device=None) -> torch.Tensor:
    """The non-uniform DFT computed directly: the dense complex oracle of
    the tests, O(M * prod(grid_shape)) work and memory, in the inputs'
    precision (the matmul in full precision: no TF32). Arguments as
    ``nufft``."""
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    source, points = entry_tensors(source, points, device=device)
    _check_dtypes(source, points)
    rank = _check_points(source, points)
    grid_shape, elem_rank, out_elem_shape = _shapes(
        source, points, grid_shape, transform_type, rank)
    sign = -1.0 if fft_direction == "forward" else 1.0
    k_vecs = [np.arange(n) - n // 2 for n in grid_shape]
    k_grid = np.stack(np.meshgrid(*k_vecs, indexing="ij"),
                      axis=0).reshape(rank, -1)
    k_grid = torch.as_tensor(k_grid, dtype=points.dtype,
                             device=points.device)

    def core(src, pts, _spec=None):
        # The phase as a sum of rank products (no matmul, so no TF32).
        phase = (pts[:, :, None] * k_grid[None]).sum(dim=1)    # [M, N]
        mat = torch.polar(torch.ones_like(phase), sign * phase)
        with _full_precision_matmul():
            if transform_type == "type_1":
                return (src @ mat).reshape((src.shape[0],) + grid_shape)
            return src.reshape(src.shape[0], -1) @ mat.T

    return _apply_batched(core, source, points, None, elem_rank,
                          out_elem_shape, None)


@contextlib.contextmanager
def _full_precision_matmul():
    """TF32 off for CUDA matmuls inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
