"""Planar-real NUFFT API: complex values as a trailing (re, im) channel.

Counterpart of ``tensorflow_nufft_tpu.planar`` for ranks 2 and 3 (2D
and 3D): ``nufft``, the standalone ``interp`` and ``spread``, the dense
oracle ``nudft`` and the planned ``PlannedNufft``. A complex tensor
``z`` is carried as ``to_planar(z)`` = real [..., 2].

The entry points run on the CUDA card unless the caller asks for the
CPU: tensors stay on their device, and numpy arrays or lists go to the
card unless ``device=`` says otherwise (see ``utils.dtypes.
entry_tensors``). On a CUDA tensor the spread/interp stages, and at rank
3 the mode stages around cuFFT, run the hand-written Hopper kernels
(float32 only); on a CPU tensor their plain PyTorch versions.

Gradients: ``nufft``, ``interp`` and ``spread`` are differentiable in
``source`` and ``points``, ``PlannedNufft`` in its source (through
``adjoint()``); a plan's points are plan data. These are real functions,
so a gradient is the real transpose, the planar form of the complex
adjoint: gradients of a real loss equal the JAX package's ``jax.vjp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.fft.planar_fft import (
    amplify_pad_dft_tiled, dft_truncate_deconvolve_tiled)
from tensorflow_nufft_tpu_torch.kernels import binning, dispatch
from tensorflow_nufft_tpu_torch.ops.nufft_ops import (
    VALID_FFT_DIRECTIONS, VALID_TRANSFORM_TYPES, _apply_batched,
    _canonical_grid_shape, _validate_enum)
from tensorflow_nufft_tpu_torch.ops.planar_core import (
    bin_for_plan, nufft_core_planar, spread_only_core_planar)
from tensorflow_nufft_tpu_torch.options.options import Options
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, auto_max_batch_size, log_plan_summary, make_plan,
    warn_if_tol_clamped)
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    FLOAT_DTYPES, as_tensor, dtype_name, entry_tensors)


def to_planar(z) -> torch.Tensor:
    """Complex array or tensor -> planar real tensor [..., 2]."""
    if isinstance(z, torch.Tensor):
        return torch.view_as_real(z.resolve_conj()).clone()
    z = np.asarray(z)
    return torch.from_numpy(np.stack([z.real, z.imag], axis=-1))


def from_planar(p) -> torch.Tensor:
    """Planar real tensor [..., 2] -> complex tensor."""
    p = as_tensor(p)
    return torch.complex(p[..., 0], p[..., 1])


def _check_planar_inputs(source, points, name="source"):
    if source.dtype not in FLOAT_DTYPES:
        raise TypeError(
            f"planar {name} must be float32 or float64, got "
            f"{source.dtype}.")
    if source.ndim < 1 or source.shape[-1] != 2:
        raise ValueError(
            f"planar {name} must have a trailing (re, im) axis of size 2, "
            f"got shape {tuple(source.shape)}.")
    if points.dtype != source.dtype:
        raise TypeError(
            f"points must have dtype {source.dtype} (same as planar "
            f"{name}), got {points.dtype}.")
    if points.ndim < 2:
        raise ValueError(
            f"points must have shape [..., M, rank], got "
            f"{tuple(points.shape)}.")
    if source.device != points.device:
        raise ValueError(
            f"source and points must be on one device, got "
            f"{source.device} and {points.device}.")


def _check_rank(rank: int) -> None:
    if rank not in (2, 3):
        raise NotImplementedError(
            f"only rank-2 and rank-3 transforms are ported so far, got "
            f"rank {rank}.")


def _planar_shapes(source, points, grid_shape, transform_type):
    """(grid_shape, elem_rank, out_elem_shape) of a planar transform."""
    rank = int(points.shape[-1])
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
        if source.ndim < 2 or int(source.shape[-2]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"{tuple(source.shape)} vs {num_points}.")
        return grid_shape, 2, grid_shape + (2,)
    if source.ndim < rank + 1:
        raise ValueError(
            f"planar source must have at least rank {rank + 1}, got "
            f"shape {tuple(source.shape)}.")
    grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
    return grid_shape, rank + 1, (num_points, 2)


def nufft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          tol: float = 1e-6,
          options: Optional[Options] = None,
          device=None) -> torch.Tensor:
    """Planar NUFFT (rank 2 or 3).

    Args:
        source: planar complex: [..., M, 2] (type-1) or
            [...] + grid_shape + [2] (type-2), float32/float64.
        points: [..., M, rank] same float dtype and device, radians in
            [-pi, pi] (wider per ``options.points_range``).
        grid_shape: the type-1 output grid shape.
        device: where to run. By default tensors stay where they are and
            numpy/list input goes to the CUDA card (raises without one).

    Returns:
        [...] + grid_shape + [2] (type-1) or [..., M, 2] (type-2), batch
        dims broadcast; modes in CMCL order (index i is k = i - N//2).
    """
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    return _run(nufft_core_planar, transform_type, fft_direction, False,
                source, points, grid_shape, tol, options, device)


def interp(source, points, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Planar standalone interpolation (rank 2 or 3): the fine grid
    ``source`` [..., *grid, 2] (no oversampling: even dims, larger than
    twice the kernel width, 5-smooth) read at ``points`` [..., M, rank]
    with the ES kernel of ``tol``, scaled to unit kernel integral.
    Returns [..., M, 2]; runs where ``nufft`` would (``device``)."""
    return _run(spread_only_core_planar, "type_2", "forward", True, source,
                points, None, tol, options, device)


def spread(source, points, grid_shape, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Planar standalone spreading (rank 2 or 3), the transpose of
    ``interp``: point values ``source`` [..., M, 2] spread onto the grid
    ``grid_shape``. Returns [..., *grid_shape, 2]."""
    return _run(spread_only_core_planar, "type_1", "forward", True, source,
                points, grid_shape, tol, options, device)


def _run(core_fn, transform_type, fft_direction, spread_only, source,
         points, grid_shape, tol, options, device) -> torch.Tensor:
    """Validates, plans and runs ``core_fn`` over the broadcast batch."""
    options = options or Options()
    source, points = entry_tensors(source, points, device=device)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    _check_rank(rank)
    grid_shape, elem_rank, out_elem_shape = _planar_shapes(
        source, points, grid_shape, transform_type)
    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=grid_shape,
        dtype_name=dtype_name(source.dtype),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=spread_only,
        upsampling_factor=None if spread_only else options.upsampling_factor,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )
    warn_if_tol_clamped(tol, spec.dtype_name, options.show_warnings)
    log_plan_summary(spec, options.verbosity)
    max_bs = options.max_batch_size
    if max_bs is None:
        max_bs = auto_max_batch_size(spec, channels_per_batch=2)
    return _apply_batched(core_fn, source, points, spec, elem_rank,
                          out_elem_shape, max_bs)


def nudft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          device=None) -> torch.Tensor:
    """Planar dense NUDFT oracle (testing): O(M * prod(grid_shape))
    work and memory, real arithmetic in the inputs' precision. Runs
    where ``nufft`` would (``device``)."""
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    source, points = entry_tensors(source, points, device=device)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    grid_shape, elem_rank, out_elem_shape = _planar_shapes(
        source, points, grid_shape, transform_type)
    sign = -1.0 if fft_direction == "forward" else 1.0
    k_vecs = [np.arange(n) - n // 2 for n in grid_shape]
    k_grid = np.stack(np.meshgrid(*k_vecs, indexing="ij"),
                      axis=0).reshape(rank, -1)
    k_grid = torch.as_tensor(k_grid, dtype=points.dtype,
                             device=points.device)

    def core(src, pts, _spec=None):
        theta = pts @ k_grid                      # [M, N]
        cos = torch.cos(theta)
        sin = sign * torch.sin(theta)
        if transform_type == "type_1":
            sr, si = src[..., 0], src[..., 1]     # [B, M]
            yr = sr @ cos - si @ sin
            yi = sr @ sin + si @ cos
            out = torch.stack([yr, yi], dim=-1)
            return out.reshape((src.shape[0],) + grid_shape + (2,))
        flat = src.reshape(src.shape[0], -1, 2)   # [B, N, 2]
        sr, si = flat[..., 0], flat[..., 1]
        yr = sr @ cos.T - si @ sin.T
        yi = sr @ sin.T + si @ cos.T
        return torch.stack([yr, yi], dim=-1)

    return _apply_batched(core, source, points, None, elem_rank,
                          out_elem_shape, None)


class PlannedNufft:
    """Planned planar NUFFT (rank 2 or 3): fixed points, repeated
    applies.

    Precomputes everything that depends only on the points: the
    two-float fold, the tile binning and the per-slot kernel windows
    (``binning.KernelWeights``, the counterpart of the JAX package's
    "mats" plan level). Each call then runs only the value-dependent
    work: the values gather, the spread or interp kernel, and the FFT
    stage. Differentiable in the source (the backward applies
    ``adjoint()``); the points are plan data and may not require grad.

    Args:
        points: [M, rank] float32/float64 tensor or array.
        grid_shape: the mode grid (type-1 output, type-2 input).
        device: where the plan lives. By default a tensor's own device,
            and the CUDA card for numpy/list points (raises without
            one); pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, points, grid_shape, transform_type="type_2",
                 fft_direction="forward", tol: float = 1e-6,
                 options: Optional[Options] = None, device=None):
        transform_type = _validate_enum(
            transform_type, VALID_TRANSFORM_TYPES, "transform_type")
        fft_direction = _validate_enum(
            fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
        options = options or Options()
        points, = entry_tensors(points, device=device)
        if points.requires_grad:
            raise ValueError(
                "a plan's points are plan data: PlannedNufft gives no "
                "gradient with respect to them (its binning and windows "
                "are precomputed). Pass points.detach(), or use "
                "planar.nufft for a points gradient.")
        if points.ndim != 2:
            raise ValueError(
                f"planned transforms take a single [M, rank] point set, "
                f"got shape {tuple(points.shape)}")
        if points.dtype not in FLOAT_DTYPES:
            raise TypeError(f"points must be float32 or float64, got "
                            f"{points.dtype}")
        grid_shape = _canonical_grid_shape(grid_shape)
        rank = int(points.shape[-1])
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must have rank {rank}, got {grid_shape}")
        _check_rank(rank)
        self.points = points
        self.grid_shape = grid_shape
        self.transform_type = transform_type
        self.fft_direction = fft_direction
        self.tol = float(tol)
        self.options = options
        self.spec = PlanSpec(
            transform_type=transform_type, fft_direction=fft_direction,
            rank=rank, grid_shape=grid_shape,
            dtype_name=dtype_name(points.dtype), tol=float(tol),
            points_range=int(options.points_range), spread_only=False,
            upsampling_factor=options.upsampling_factor,
            kernel_evaluation_method=options.kernel_evaluation_method)
        warn_if_tol_clamped(tol, self.spec.dtype_name,
                            options.show_warnings)
        self.plan = make_plan(self.spec)
        self.geom, self.binned = bin_for_plan(points, self.plan)
        self.weights = binning.build_weight_payload(self.binned, self.geom,
                                                    self.plan)
        self._adjoint = None

    @property
    def device(self) -> torch.device:
        return self.points.device

    def adjoint(self) -> "PlannedNufft":
        """The adjoint planned transform (swapped type and direction),
        sharing all points-side artifacts."""
        if self._adjoint is None:
            adj = object.__new__(PlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            adj.spec = dataclasses.replace(
                self.spec, transform_type=adj.transform_type,
                fft_direction=adj.fft_direction)
            adj.plan = make_plan(adj.spec)
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _apply(self, source: torch.Tensor) -> torch.Tensor:
        batch = source.shape[0]
        m = self.points.shape[0]
        if self.transform_type == "type_1":
            # Channel-major fold: [B, M, 2] -> [2B, M] (row order (b, ch)).
            src_cm = source.movedim(-1, 1).reshape(2 * batch, m)
            tiles = dispatch.spread_tiled(src_cm, self.binned, self.geom,
                                          self.plan, kw=self.weights)
            return dft_truncate_deconvolve_tiled(tiles, self.plan,
                                                 self.geom, batch)
        tiles = amplify_pad_dft_tiled(source, self.plan, self.geom)
        values = dispatch.interp_tiled(tiles, self.binned, self.geom,
                                       self.plan, kw=self.weights)
        return values.reshape(batch, 2, m).movedim(1, -1)

    def __call__(self, source) -> torch.Tensor:
        """Applies the transform to planar ``source``.

        Type-2: [B, *grid, 2] -> [B, M, 2]; type-1: [B, M, 2] ->
        [B, *grid, 2]. A leading batch dim is required (use B=1).
        ``source`` is moved to the plan's device and must have the
        dtype of the plan's points. Differentiable in ``source``: the
        gradient applies ``adjoint()``.
        """
        source = as_tensor(source, device=self.device)
        m = int(self.points.shape[0])
        if self.transform_type == "type_1":
            expect = f"[B, {m}, 2]"
            ok = (source.ndim == 3 and source.shape[1] == m
                  and source.shape[-1] == 2)
        else:
            expect = "[B, {}, 2]".format(
                ", ".join(str(g) for g in self.grid_shape))
            ok = (source.ndim == len(self.grid_shape) + 2
                  and tuple(source.shape[1:-1]) == self.grid_shape
                  and source.shape[-1] == 2)
        if not ok:
            raise ValueError(
                f"planned {self.transform_type} expects a source of "
                f"shape {expect} (leading batch, trailing (re, im)); "
                f"got shape {tuple(source.shape)}")
        if source.dtype != self.points.dtype:
            raise TypeError(
                f"source must have the plan's dtype {self.points.dtype}, "
                f"got {source.dtype}")
        return _PlannedCall.apply(source, self)


class _PlannedCall(torch.autograd.Function):
    """A planned apply whose backward is the adjoint plan's apply (the
    real transpose; JAX ``_planned_bwd``)."""

    @staticmethod
    def forward(ctx, source, op):
        ctx.op = op
        return op._apply(source.contiguous())

    @staticmethod
    def backward(ctx, cotangent):
        return _PlannedCall.apply(cotangent, ctx.op.adjoint()), None
