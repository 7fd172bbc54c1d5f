"""Planar-real NUFFT API: complex values as a trailing (re, im) channel.

Counterpart of ``tensorflow_nufft_tpu.planar`` for ranks 1, 2 and 3:
``nufft``, the standalone ``interp`` and ``spread``, the dense oracle
``nudft``, the planned ``PlannedNufft``, its per-trajectory stack
``BatchedPlannedNufft``, and the type-3 transforms (``Type3Plan``,
``nufft_type3`` and the oracle ``nudft_type3``). A complex tensor
``z`` is carried as ``to_planar(z)`` = real [..., 2].

The entry points run on the CUDA card unless the caller asks for the
CPU: tensors stay on their device, and numpy arrays or lists go to the
card unless ``device=`` says otherwise (see ``utils.dtypes.
entry_tensors``). On a float32 CUDA tensor the spread/interp stages,
and at rank 3 the mode stages and their FFT, run the hand-written Hopper
kernels; on a CPU tensor their plain PyTorch versions. Float64 on the
card, and ``Options(backend='xla')`` anywhere, run the torch-op
counterpart of the JAX package's XLA path (``kernels.dispatch.route``);
``Options(backend='native')`` runs that path's spread and interp on the
native C++ host engine. ``ToeplitzNormal`` is the Toeplitz-embedded
normal operator.

Gradients: ``nufft``, ``interp`` and ``spread`` are differentiable in
``source`` and ``points``; ``PlannedNufft``, ``BatchedPlannedNufft`` and
``Type3Plan`` in their source (through ``adjoint()``), ``PlannedNufft``
also in its slot-order values and ``normal``'s source; a plan's points
and slot weights are plan data. These are real functions,
so a gradient is the real transpose, the planar form of the complex
adjoint: gradients of a real loss equal the JAX package's ``jax.vjp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.fft.planar_fft import (
    amplify_pad_dft_tiled, dft_doubled_planar, dft_planar, spread_dft_fused)
from tensorflow_nufft_tpu_torch.kernels import binning, dispatch
from tensorflow_nufft_tpu_torch.ops.nufft_ops import (
    VALID_FFT_DIRECTIONS, VALID_TRANSFORM_TYPES, _apply_batched,
    _canonical_grid_shape, _full_precision_matmul, _validate_enum,
    check_points_range)
from tensorflow_nufft_tpu_torch.ops.planar_core import (
    FULL_GRID_ROUTES, bin_for_plan, nufft_core_planar,
    spread_only_core_planar)
from tensorflow_nufft_tpu_torch.ops.type3 import (
    FineSpread, compute_type3_statics, validate_type3_point_sets)
from tensorflow_nufft_tpu_torch.options.options import Options
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, auto_max_batch_size, log_plan_summary, make_plan,
    warn_if_tol_clamped)
from tensorflow_nufft_tpu_torch.utils import profiling as prof
from tensorflow_nufft_tpu_torch.utils.batching import chunked_map
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
    if rank not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {rank}.")


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
    """Planar NUFFT (rank 1, 2 or 3).

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
                source, points, grid_shape, tol, options, device,
                check_range=True)


def interp(source, points, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Planar standalone interpolation (rank 1, 2 or 3): the fine grid
    ``source`` [..., *grid, 2] (no oversampling: even dims, larger than
    twice the kernel width, 5-smooth) read at ``points`` [..., M, rank]
    with the ES kernel of ``tol``, scaled to unit kernel integral.
    Returns [..., M, 2]; runs where ``nufft`` would (``device``)."""
    return _run(spread_only_core_planar, "type_2", "forward", True, source,
                points, None, tol, options, device)


def spread(source, points, grid_shape, tol: float = 1e-6,
           options: Optional[Options] = None, device=None) -> torch.Tensor:
    """Planar standalone spreading (rank 1, 2 or 3), the transpose of
    ``interp``: point values ``source`` [..., M, 2] spread onto the grid
    ``grid_shape``. Returns [..., *grid_shape, 2]."""
    return _run(spread_only_core_planar, "type_1", "forward", True, source,
                points, grid_shape, tol, options, device)


def _run(core_fn, transform_type, fft_direction, spread_only, source,
         points, grid_shape, tol, options, device, check_range=False
         ) -> torch.Tensor:
    """Validates, plans and runs ``core_fn`` over the broadcast batch;
    with ``check_range`` (``nufft``), the points-range check where
    ``options.debugging`` asks for it."""
    options = options or Options()
    source, points = entry_tensors(source, points, device=device)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    _check_rank(rank)
    grid_shape, elem_rank, out_elem_shape = _planar_shapes(
        source, points, grid_shape, transform_type)
    if check_range and options.debugging.check_points_range:
        check_points_range(points, options)
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
        backend=options.backend,
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
    _check_rank(rank)
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
    """Planned planar NUFFT (rank 1, 2 or 3): fixed points, repeated
    applies.

    Precomputes everything that depends only on the points, at one of
    the JAX package's plan levels (``level``), chosen by its rule
    (``planar.py:519-532``):

    - "mats": the two-float fold, the tile binning and the per-slot
      kernel windows (``binning.KernelWeights``), when the dense kernel
      matrices a JAX plan would keep fit ``binning.MATS_BYTES_BUDGET``;
    - "binned": the binning and the coords payload, the kernels
      evaluating the windows. At rank 3 the binning is z-ordered on a
      coarse axis-0 geometry with its axis-0 band (``band_info``), which
      the banded kernels use; a band that degenerates to the whole
      extended tile re-plans on the unbanded geometry.
    - "none" for float64 points, ``backend='xla'`` and
      ``backend='native'`` (the JAX package's Pallas path, like the
      port's kernels, is float32 only; ``backend='pallas'`` on float64
      raises): applies run ``planar.nufft`` and slot order is point
      order.

    Each call then runs only the value-dependent work. Besides
    ``__call__`` and ``adjoint()``, the slot surface of iterative
    solvers keeps per-point vectors in the kernels' chunk-slot order
    (``num_slots``, ``slot_mask``, ``to_slots``/``from_slots``,
    ``apply_to_slots``/``apply_from_slots``, ``slot_weights``) and
    ``normal`` applies A^H W A with the point values kept in slot order.
    Differentiable in the source (and slot values); the points are plan
    data and may not require grad.

    Spans (``utils.profiling.scope``; the JAX planned path has none): a
    type-1 apply runs under ``plan.apply``, ``normal`` under
    ``plan.normal`` and the slot applies under ``plan.slots``, their
    stages under the unplanned path's stage names (``nufft.spread``,
    ``nufft.mode_dft_deconvolve``, ``nufft.amplify_dft``,
    ``nufft.interp``). A lone type-2 apply opens no span.

    Args:
        points: [M, rank] float32/float64 tensor or array.
        grid_shape: the mode grid (type-1 output, type-2 input).
        payload_budget_bytes: the dense-matrix budget of the "mats"
            level (``binning.MATS_BYTES_BUDGET`` by default); callers
            building many plans (``BatchedPlannedNufft``, the inner
            type-2 of ``Type3Plan``) pass a share of it.
        device: where the plan lives. By default a tensor's own device,
            and the CUDA card for numpy/list points (raises without
            one); pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, points, grid_shape, transform_type="type_2",
                 fft_direction="forward", tol: float = 1e-6,
                 options: Optional[Options] = None,
                 payload_budget_bytes: Optional[int] = None, device=None):
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
            backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        warn_if_tol_clamped(tol, self.spec.dtype_name,
                            options.show_warnings)
        self.plan = make_plan(self.spec)
        self._adjoint = None
        self.geom = self.binned = self.weights = self.coords = None
        self.band_info = None
        if (dispatch.route(self.spec, points.device) in FULL_GRID_ROUTES
                or points.dtype != torch.float32):
            # The JAX package plans only what its Pallas kernels serve.
            self.level = "none"
            return
        plan, m = self.plan, int(points.shape[0])
        geom = binning.choose_geometry(plan.fine_shape, plan.width, m)
        budget = (binning.MATS_BYTES_BUDGET if payload_budget_bytes is None
                  else payload_budget_bytes)
        self.level = ("mats" if binning.mats_supported(geom)
                      and binning.mats_payload_bytes(geom) <= budget
                      else "binned")
        zorder = self.level == "binned" and rank == 3
        if zorder:
            unbanded = geom
            geom = binning.choose_geometry(plan.fine_shape, plan.width, m,
                                           banded=True)
        self._bin(geom, zorder)
        band = self.band_info.band if self.band_info else None
        if zorder and not binning.streaming_group_size(geom, band):
            # The JAX plan's re-plan rule (PlannedNufft._ensure_viable): its
            # memory model rejects this band (wide or degenerate axis-0
            # spans), so it re-plans on the unbanded geometry, or runs
            # unplanned where that one is rejected too.
            if (not binning.geometry_valid(unbanded)
                    or not binning.streaming_group_size(unbanded)):
                self.level = "none"
                self.geom = self.binned = self.coords = None
                self.band_info = None
                return
            self._bin(unbanded, zorder)

    def _bin(self, geom: binning.TileGeometry, zorder: bool) -> None:
        """Bins the points on ``geom`` and installs the level's
        artifacts: the windows ("mats") or the coords payload and, with
        ``zorder``, the axis-0 band where it is narrower than E0."""
        self.geom, self.binned = bin_for_plan(self.points, self.plan, geom,
                                              zorder)
        if self.level == "mats":
            self.weights = binning.build_weight_payload(self.binned, geom,
                                                        self.plan)
        else:
            self.coords = binning.build_coords_payload(self.binned)
        self.band_info = None
        if zorder:
            band, zorigins = binning.compute_band_origins(
                self.binned, geom, self.plan.half_width)
            if band < geom.ext[0]:
                self.band_info = binning.BandInfo(
                    band, torch.as_tensor(zorigins, device=self.device))

    @property
    def device(self) -> torch.device:
        return self.points.device

    @classmethod
    def batch_build(cls, points_stack, grid_shape,
                    transform_type="type_2", fft_direction="forward",
                    tol: float = 1e-6, options: Optional[Options] = None,
                    payload_budget_bytes: Optional[int] = None,
                    device=None) -> list:
        """One plan per leading slice of ``points_stack`` ([S, M,
        rank]), each with ``payload_budget_bytes``. Equal shard sizes give
        every shard the same geometry and level; a shard whose band
        degenerates re-plans alone, as its own constructor decides. The
        JAX package traces the shards' preprocessing as one vmapped jit;
        here each shard bins in its own eager pass."""
        points_stack, = entry_tensors(points_stack, device=device)
        return [cls(points_stack[i], grid_shape,
                    transform_type=transform_type,
                    fft_direction=fft_direction, tol=tol, options=options,
                    payload_budget_bytes=payload_budget_bytes)
                for i in range(points_stack.shape[0])]

    @classmethod
    def from_batch(cls, points_batch, grid_shape, **kwargs
                   ) -> "BatchedPlannedNufft":
        """Batched planned transforms over stacked per-batch
        trajectories ([S, M, rank] -> one planned transform per slice,
        applied in one call); see ``BatchedPlannedNufft``."""
        return BatchedPlannedNufft(points_batch, grid_shape, **kwargs)

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

    # -- the planned stages ------------------------------------------------

    def _type1(self, values_pl: torch.Tensor, batch: int) -> torch.Tensor:
        """Slot-order values [2B, num_slots] -> modes [B, *grid, 2]."""
        return spread_dft_fused(values_pl, self.binned, self.geom,
                                self.plan, batch, kw=self.weights,
                                coords=self.coords, band=self.band_info)

    def _interp(self, tiles: torch.Tensor, chunk_order: bool
                ) -> torch.Tensor:
        return dispatch.interp_tiled(tiles, self.binned, self.geom,
                                     self.plan, kw=self.weights,
                                     coords=self.coords,
                                     band=self.band_info,
                                     chunk_order=chunk_order)

    def _type2_slots(self, source: torch.Tensor) -> torch.Tensor:
        """Modes [B, *grid, 2] -> slot-order values [2B, num_slots], each
        stage under its span."""
        with prof.scope("nufft.amplify_dft"):
            tiles = amplify_pad_dft_tiled(source, self.plan, self.geom)
        with prof.scope("nufft.interp"):
            return self._interp(tiles, chunk_order=True)

    def _unplanned(self, source: torch.Tensor) -> torch.Tensor:
        """Level "none": the unplanned transform."""
        return nufft(source, self.points,
                     self.grid_shape if self.transform_type == "type_1"
                     else None, self.transform_type, self.fft_direction,
                     self.tol, self.options)

    def _apply(self, source: torch.Tensor) -> torch.Tensor:
        if self.level == "none":
            return self._unplanned(source)
        batch = source.shape[0]
        m = self.points.shape[0]
        if self.transform_type == "type_1":
            with prof.scope("plan.apply"):
                # Channel-major fold: [B, M, 2] -> [2B, M] (row order
                # (b, ch)).
                src_cm = source.movedim(-1, 1).reshape(2 * batch, m)
                return self._type1(
                    binning.build_values_payload(src_cm, self.binned), batch)
        # No span: under torch.profiler the host work of a lone planned
        # type-2 is about its device time (3D, 800k points, H100), so spans
        # here would make its traced idle share read their cost.
        tiles = amplify_pad_dft_tiled(source, self.plan, self.geom)
        values = self._interp(tiles, chunk_order=False)
        return values.reshape(batch, 2, m).movedim(1, -1)

    def _check_source(self, source, what: str) -> torch.Tensor:
        """``source`` as a tensor of the plan's device and dtype, raising
        unless it has ``what``'s shape: [B, M, 2] ("points"), [B, S, 2]
        ("slots") or [B, *grid, 2] ("grid")."""
        source = as_tensor(source, device=self.device)
        if what == "grid":
            expect = tuple(self.grid_shape)
            ok = (source.ndim == len(expect) + 2
                  and tuple(source.shape[1:-1]) == expect)
        else:
            expect = (int(self.points.shape[0]) if what == "points"
                      else self.num_slots,)
            ok = source.ndim == 3 and source.shape[1] == expect[0]
        if not (ok and source.shape[-1] == 2):
            raise ValueError(
                f"expects a source of shape [B, "
                f"{', '.join(str(g) for g in expect)}, 2] (leading batch, "
                f"trailing (re, im)); got shape {tuple(source.shape)}")
        if source.dtype != self.points.dtype:
            raise TypeError(
                f"source must have the plan's dtype {self.points.dtype}, "
                f"got {source.dtype}")
        return source

    def __call__(self, source) -> torch.Tensor:
        """Applies the transform to planar ``source``.

        Type-2: [B, *grid, 2] -> [B, M, 2]; type-1: [B, M, 2] ->
        [B, *grid, 2]. A leading batch dim is required (use B=1).
        ``source`` is moved to the plan's device and must have the
        dtype of the plan's points. Differentiable in ``source``: the
        gradient applies ``adjoint()``.
        """
        try:
            source = self._check_source(
                source, "points" if self.transform_type == "type_1"
                else "grid")
        except ValueError as err:
            raise ValueError(f"planned {self.transform_type} {err}") \
                from None
        return _PlannedCall.apply(source, self)

    # -- the slot surface --------------------------------------------------
    # The planned kernels' native point layout is the chunk-padded slot
    # stream (binning.BinnedPoints). Iterative solvers that keep per-point
    # vectors in slot order skip the point-order gathers of every apply:
    # convert fixed data once with to_slots, then loop on
    # apply_to_slots / apply_from_slots, or on normal.

    @property
    def num_slots(self) -> int:
        """Length S of the slot axis ([B, S, 2] slot-order vectors); M at
        level "none"."""
        if self.level == "none":
            return int(self.points.shape[0])
        return self.geom.num_slots

    @property
    def slot_mask(self) -> torch.Tensor:
        """[S] 1 where the slot holds a point, 0 in padded and unused
        slots (in the points' dtype), for slot-space reductions."""
        if self.level == "none":
            return torch.ones(self.num_slots, dtype=self.points.dtype,
                              device=self.device)
        return (self.binned.invpos < self.points.shape[0]).to(
            self.points.dtype)

    def slot_weights(self, weights) -> torch.Tensor:
        """Per-point real weights [M] (density compensation) -> slot
        order [S] for ``normal``, zero in padded slots. Compute once per
        weight vector."""
        weights = as_tensor(weights, device=self.device)
        if self.level == "none":
            return weights
        return binning.slot_order_scalar(weights, self.binned)

    def normal(self, source, slot_w=None) -> torch.Tensor:
        """The normal operator A^H W A, A the type-2 direction of this
        plan: the type-2 apply and its adjoint with the point values kept
        in slot order (chunk-order interp, slot-order spread), so neither
        point-order gather runs.

        Args:
            source: [B, *grid, 2] planar images.
            slot_w: optional [S] slot-order real weights from
                ``slot_weights``; plan data (no gradient).

        Returns:
            [B, *grid, 2] planar ``A^H W A source``; differentiable in
            ``source`` (the operator is its own transpose).
        """
        source = self._check_source(source, "grid")
        if slot_w is not None:
            slot_w = as_tensor(slot_w, dtype=self.points.dtype,
                               device=self.device).detach()
        t2 = self if self.transform_type == "type_2" else self.adjoint()
        if self.level == "none":
            vals = t2(source)
            if slot_w is not None:
                vals = vals * slot_w[None, :, None]
            return t2.adjoint()(vals)
        return _PlannedNormal.apply(source, slot_w, t2)

    def to_slots(self, values) -> torch.Tensor:
        """Point-order planar values [B, M, 2] -> slot order [B, S, 2]
        (zeros in padded and unused slots): one gather; convert
        loop-invariant data once. Its gradient is ``from_slots``."""
        values = self._check_source(values, "points")
        if self.level == "none":
            return values
        return _ToSlots.apply(values, self)

    def from_slots(self, slot_values) -> torch.Tensor:
        """Slot-order planar values [B, S, 2] -> point order [B, M, 2]
        (the inverse of ``to_slots``, and its gradient)."""
        slot_values = self._check_source(slot_values, "slots")
        if self.level == "none":
            return slot_values
        return _FromSlots.apply(slot_values, self)

    def apply_to_slots(self, source) -> torch.Tensor:
        """The type-2 apply with slot-order output [B, S, 2]:
        ``to_slots(self(source))`` without the point-order gather; padded
        and unused slots come out exactly zero. Differentiable in
        ``source`` (through the adjoint's ``apply_from_slots``)."""
        if self.transform_type != "type_2":
            raise ValueError(
                "apply_to_slots is the type-2 (grid -> points) apply; "
                "this plan is type_1 (use adjoint(), or apply_from_slots)")
        source = self._check_source(source, "grid")
        if self.level == "none":
            return self(source)
        return _PlannedSlots.apply(source, self)

    def apply_from_slots(self, slot_values) -> torch.Tensor:
        """The type-1 apply from slot-order values [B, S, 2] -> [B, *grid,
        2], without the values gather of ``__call__``; padded and unused
        input slots are masked out (``torch.where``, so even NaN there
        does not leak). Differentiable in ``slot_values``."""
        if self.transform_type != "type_1":
            raise ValueError(
                "apply_from_slots is the type-1 (points -> grid) apply; "
                "this plan is type_2 (use adjoint(), or apply_to_slots)")
        slot_values = self._check_source(slot_values, "slots")
        if self.level == "none":
            return self(slot_values)
        return _PlannedSlots.apply(slot_values, self)

    def _apply_slots(self, source: torch.Tensor) -> torch.Tensor:
        with prof.scope("plan.slots"):
            batch = source.shape[0]
            keep = self.binned.invpos < self.points.shape[0]
            if self.transform_type == "type_1":
                src_cm = source.movedim(-1, 1).reshape(2 * batch, -1)
                return self._type1(torch.where(keep[None], src_cm, 0.0),
                                   batch)
            flat = torch.where(keep[None], self._type2_slots(source), 0.0)
            return flat.reshape(batch, 2, -1).movedim(1, -1)

    def _apply_normal(self, source: torch.Tensor,
                      slot_w: Optional[torch.Tensor]) -> torch.Tensor:
        """A^H W A on a type-2 plan (``self``)."""
        with prof.scope("plan.normal"):
            flat = self._type2_slots(source)                   # [2B, S]
            if slot_w is not None:
                flat = flat * slot_w[None]
            return self.adjoint()._type1(flat, source.shape[0])

    def _to_slots(self, values: torch.Tensor) -> torch.Tensor:
        batch = values.shape[0]
        flat = binning.build_values_payload(
            values.movedim(-1, 1).reshape(2 * batch, -1), self.binned)
        return flat.reshape(batch, 2, -1).movedim(1, -1)

    def _from_slots(self, slot_values: torch.Tensor) -> torch.Tensor:
        batch = slot_values.shape[0]
        flat = binning.scatter_chunked(
            slot_values.movedim(-1, 1).reshape(2 * batch, -1), self.binned)
        return flat.reshape(batch, 2, -1).movedim(1, -1)


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


class _PlannedNormal(torch.autograd.Function):
    """A^H W A with real W is self-adjoint, and the planar-real transpose
    of a self-adjoint complex-linear operator is itself (JAX
    ``_planned_normal_bwd``); the weights are plan data."""

    @staticmethod
    def forward(ctx, source, slot_w, op):
        ctx.op, ctx.slot_w = op, slot_w
        return op._apply_normal(source.contiguous(), slot_w)

    @staticmethod
    def backward(ctx, cotangent):
        return (_PlannedNormal.apply(cotangent, ctx.slot_w, ctx.op), None,
                None)


class _PlannedSlots(torch.autograd.Function):
    """A slot-order apply: the point-order operator conjugated by the
    slot embedding (both directions mask to real slots), so its transpose
    is the adjoint plan's slot-order apply (JAX ``_planned_slots_bwd``)."""

    @staticmethod
    def forward(ctx, source, op):
        ctx.op = op
        return op._apply_slots(source.contiguous())

    @staticmethod
    def backward(ctx, cotangent):
        return _PlannedSlots.apply(cotangent, ctx.op.adjoint()), None


class _ToSlots(torch.autograd.Function):
    """The slot embedding E (zeros in padded slots); its transpose is the
    gather back, ``from_slots``."""

    @staticmethod
    def forward(ctx, values, op):
        ctx.op = op
        return op._to_slots(values)

    @staticmethod
    def backward(ctx, cotangent):
        return _FromSlots.apply(cotangent, ctx.op), None


class _FromSlots(torch.autograd.Function):
    """E^T, whose transpose is ``to_slots``."""

    @staticmethod
    def forward(ctx, slot_values, op):
        ctx.op = op
        return op._from_slots(slot_values)

    @staticmethod
    def backward(ctx, cotangent):
        return _ToSlots.apply(cotangent, ctx.op), None


class BatchedPlannedNufft:
    """Planned planar NUFFT over a stack of trajectories: points
    [S, M, rank], one planned transform per leading slice, applied in one
    call (per-batch trajectories, as in dynamic MRI, where every frame has
    its own trajectory).

    The shards are ``PlannedNufft.batch_build``'s plans; each takes the
    plan level of a ``PlannedNufft`` whose dense-matrix budget is
    ``binning.MATS_BYTES_BUDGET // S`` (the JAX package splits its payload
    budget S ways), so wide stacks take the "binned" level.

    Apply shapes (planar, one transform per trajectory):
      type_2: [S, *grid, 2] -> [S, M, 2]
      type_1: [S, M, 2]     -> [S, *grid, 2]
    An optional inner batch axis B (transforms sharing trajectory i) is
    accepted as [S, B, ...] -> [S, B, ...].

    Differentiable in ``source`` (the gradient applies the adjoint batch,
    which shares every shard's artifacts); the points are plan data and
    may not require grad. Where a shard is at level "none" (float64,
    ``backend='xla'``), applies run ``planar.nufft`` per trajectory.

    Args:
        points_batch: [S, M, rank] float32/float64 tensor or array.
        grid_shape: the mode grid.
        device: where the plans live (as ``PlannedNufft``'s).
    """

    def __init__(self, points_batch, grid_shape, transform_type="type_2",
                 fft_direction="forward", tol: float = 1e-6,
                 options: Optional[Options] = None, device=None):
        points_batch, = entry_tensors(points_batch, device=device)
        if points_batch.ndim != 3:
            raise ValueError(
                f"BatchedPlannedNufft takes stacked [S, M, rank] "
                f"points, got shape {tuple(points_batch.shape)}")
        s = int(points_batch.shape[0])
        self.points_batch = points_batch
        self.num_batches = s
        self._shards = PlannedNufft.batch_build(
            points_batch, grid_shape, transform_type=transform_type,
            fft_direction=fft_direction, tol=tol, options=options,
            payload_budget_bytes=max(binning.MATS_BYTES_BUDGET // s, 1))
        p0 = self._shards[0]
        self.grid_shape = p0.grid_shape
        self.transform_type = p0.transform_type
        self.fft_direction = p0.fft_direction
        self.tol = p0.tol
        self.options = p0.options
        self._planned = all(sh.level != "none" for sh in self._shards)
        self._adjoint = None

    @property
    def num_points(self) -> int:
        return int(self.points_batch.shape[1])

    @property
    def device(self) -> torch.device:
        return self.points_batch.device

    def adjoint(self) -> "BatchedPlannedNufft":
        """The adjoint batch (swapped type and direction), sharing all
        per-trajectory points-side artifacts."""
        if self._adjoint is None:
            adj = object.__new__(BatchedPlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            adj._shards = [sh.adjoint() for sh in self._shards]
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _elem_rank(self) -> int:
        return (2 if self.transform_type == "type_1"
                else len(self.grid_shape) + 1)

    def _apply(self, source: torch.Tensor) -> torch.Tensor:
        inner = source.ndim == self._elem_rank() + 2
        outs = []
        for i, sh in enumerate(self._shards):
            out = sh._apply(source[i] if inner else source[i][None])
            outs.append(out if inner else out[0])
        return torch.stack(outs)

    def __call__(self, source) -> torch.Tensor:
        """Applies the per-trajectory transforms to planar ``source``
        ([S, *elem] or [S, B, *elem]; see the class docstring)."""
        source = as_tensor(source, device=self.device)
        m = self.num_points
        er = self._elem_rank()
        if self.transform_type == "type_1":
            elem_ok = (tuple(source.shape[-2:]) == (m, 2)
                       if source.ndim >= 2 else False)
            expect = f"[S, (B,) {m}, 2]"
        else:
            gs = tuple(self.grid_shape)
            elem_ok = (source.ndim >= er + 1
                       and tuple(source.shape[-er:-1]) == gs
                       and source.shape[-1] == 2)
            expect = f"[S, (B,) {', '.join(str(g) for g in gs)}, 2]"
        if (not elem_ok or source.ndim not in (er + 1, er + 2)
                or source.shape[0] != self.num_batches):
            raise ValueError(
                f"batched planned {self.transform_type} expects a "
                f"source of shape {expect} with S={self.num_batches}; "
                f"got shape {tuple(source.shape)}")
        if source.dtype != self.points_batch.dtype:
            raise TypeError(
                f"source must have the plan's dtype "
                f"{self.points_batch.dtype}, got {source.dtype}")
        if not self._planned:
            # The unplanned route: the functional op per (source,
            # trajectory) pair, as the JAX package's vmap.
            inner = source.ndim == er + 2
            src = source if inner else source[:, None]
            grid = (self.grid_shape if self.transform_type == "type_1"
                    else None)
            out = torch.stack([
                nufft(src[i], self.points_batch[i], grid,
                      self.transform_type, self.fft_direction, self.tol,
                      self.options) for i in range(self.num_batches)])
            return out if inner else out[:, 0]
        return _BatchedPlannedCall.apply(source, self)


class _BatchedPlannedCall(torch.autograd.Function):
    """A batched planned apply whose backward is the adjoint batch's
    apply (the real transpose per trajectory; JAX
    ``_batched_planned_bwd``)."""

    @staticmethod
    def forward(ctx, source, op):
        ctx.op = op
        return op._apply(source.contiguous())

    @staticmethod
    def backward(ctx, cotangent):
        return _BatchedPlannedCall.apply(cotangent, ctx.op.adjoint()), None


def pmul(values, phase) -> torch.Tensor:
    """Planar complex multiply: values [..., 2] * phase [..., 2]
    (broadcasting; ``models.mri.pmul`` is this function)."""
    vr, vi = values[..., 0], values[..., 1]
    pr, pi = phase[..., 0], phase[..., 1]
    return torch.stack([vr * pr - vi * pi, vr * pi + vi * pr], dim=-1)


class ToeplitzNormal:
    """Toeplitz-embedded normal operator ``A^H W A``.

    Counterpart of ``tensorflow_nufft_tpu.planar.ToeplitzNormal``.
    ``A^H W A`` is shift-invariant on the mode grid: convolution with
    ``t[d] = sum_j w_j e^{+/- i omega_j . d}``, one planar type-1 NUFFT of
    the weights onto the doubled grid, in the opposite direction to A,
    computed at construction. Each apply is then pad -> 2N-point DFT ->
    multiply -> cropped inverse DFT (``torch.fft``, the JAX package's XLA
    contractions): no spread or interp runs.

    The spectrum is kept at the points' precision (float32 or float64):
    truncating a float64 pipeline to float32 would stall CG far above the
    requested tolerance.

    Args:
        points: [M, rank] radians.
        grid_shape: the image (mode) grid N.
        weights: optional [M] real per-point weights (density
            compensation); ones by default.
        fft_direction: the direction of the forward model A.
        tol: accuracy of the kernel-evaluating NUFFT.
        device: where the operator lives (as ``PlannedNufft``'s).

    Apply: ``op(source)``, planar [B, *grid, 2] -> [B, *grid, 2];
    differentiable (the operator is its own transpose).
    """

    def __init__(self, points, grid_shape, weights=None,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None, device=None):
        points, = entry_tensors(points, device=device)
        if points.ndim != 2:
            raise ValueError(
                f"ToeplitzNormal takes a single [M, rank] point set, "
                f"got shape {tuple(points.shape)}")
        fft_direction = _validate_enum(
            fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
        self.grid_shape = _canonical_grid_shape(grid_shape)
        self.rank = rank = int(points.shape[-1])
        if len(self.grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {self.grid_shape}")
        m = int(points.shape[0])
        if weights is None:
            w = torch.ones(m, dtype=points.dtype, device=points.device)
        else:
            w = as_tensor(weights, dtype=points.dtype, device=points.device)
            if tuple(w.shape) != (m,):
                raise ValueError(
                    f"weights must have shape [{m}], got {tuple(w.shape)}")
        doubled = tuple(2 * n for n in self.grid_shape)
        # t[d] = sum_j w_j e^{+i omega d} for a 'forward' A: the type-1
        # NUFFT with the opposite direction.
        t1_dir = "backward" if fft_direction == "forward" else "forward"
        t = nufft(torch.stack([w, torch.zeros_like(w)], dim=-1), points,
                  grid_shape=doubled, transform_type="type_1",
                  fft_direction=t1_dir, tol=tol, options=options)
        # CMCL modes n' in [-N, N) -> spatial offsets on the 2N torus: roll
        # by -N per axis, zeroing the never-referenced offset -N (index N
        # after the roll); on the host in float64, as the JAX package.
        t_np = t.detach().cpu().numpy().astype(np.float64)
        for d in range(rank):
            n = self.grid_shape[d]
            t_np = np.roll(t_np, -n, axis=d)
            idx = [slice(None)] * t_np.ndim
            idx[d] = n
            t_np[tuple(idx)] = 0.0
        spectrum = dft_planar(
            torch.as_tensor(t_np[None], device=points.device).to(
                points.dtype), rank, "forward")[0]
        # The inverse DFT's normalization, folded in float64.
        self.spectrum = (spectrum.double() / float(np.prod(doubled))).to(
            points.dtype)

    def _apply(self, source: torch.Tensor) -> torch.Tensor:
        z = dft_doubled_planar(source.to(self.spectrum.dtype), self.rank,
                               forward=True)              # [B, *2N, 2]
        out = dft_doubled_planar(pmul(z, self.spectrum), self.rank,
                                 forward=False)
        return out.to(source.dtype)

    def __call__(self, source) -> torch.Tensor:
        source = as_tensor(source, device=self.spectrum.device)
        expect = self.rank + 2
        if source.ndim != expect or source.shape[-1] != 2:
            raise ValueError(
                f"ToeplitzNormal expects [B, *grid, 2] planar input "
                f"of rank {expect}, got shape {tuple(source.shape)}")
        return _ToeplitzCall.apply(source, self)


class _ToeplitzCall(torch.autograd.Function):
    """A^H W A with real W is self-adjoint, so its planar-real transpose
    is itself (JAX ``_toeplitz_bwd``)."""

    @staticmethod
    def forward(ctx, source, op):
        ctx.op = op
        return op._apply(source)

    @staticmethod
    def backward(ctx, cotangent):
        return _ToeplitzCall.apply(cotangent, ctx.op), None


class Type3Plan:
    """Planned planar type-3 NUFFT: nonuniform points -> nonuniform
    frequencies, f_k = sum_j c_j exp(s i t_k . x_j).

    The planar twin of the complex ``Type3Plan`` (``ops.type3`` has the
    derivation), built from planned stages: a tiled spread onto the
    type-3 fine grid with its binning and payload hoisted to plan time,
    the halo fold, and a planned type-2 (``PlannedNufft``) at the rescaled
    target frequencies.

    The outer spread is planned by the JAX package's rule where the
    kernels' route serves it (float32 off ``backend='xla'``:
    ``_spread_level`` "mats" or "binned", else "none"). The dense-matrix
    budget is shared with the inner type-2: the inner plan's own need is
    estimated first, and the outer spread takes the "mats" level only
    where both fit (or where the inner one would stream coords anyway),
    with a 16 MiB margin for a stage that streams coords; the rest goes
    to the inner plan as its ``payload_budget_bytes``.

    Apply: ``op(source)`` with planar [B, M, 2] -> [B, K, 2], float32.
    Differentiable in the strengths (the gradient applies ``adjoint()``,
    which swaps the point sets and flips the direction); the point sets
    are plan data.

    Args:
        points: [M, rank] float32 coordinates, any range; no gradient.
        target_points: [K, rank] float32 frequencies.
        device: where the plan lives (as ``PlannedNufft``'s).
    """

    def __init__(self, points, target_points,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None, device=None):
        fft_direction = _validate_enum(
            fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
        options = options or Options()
        if options.upsampling_factor not in (None, 0.0, 2.0):
            raise ValueError(
                "type-3 transforms support only upsampling_factor=2.0 "
                f"(got {options.upsampling_factor}).")
        points, target_points = entry_tensors(points, target_points,
                                              device=device)
        x, t = validate_type3_point_sets(points, target_points,
                                         allowed_dtypes=(np.float32,))
        st = compute_type3_statics(
            np.asarray(x, np.float64), np.asarray(t, np.float64),
            fft_direction, tol, real_dt=np.float32)
        self._x, self._t = points, target_points
        self.rank = st.rank
        self.num_points = st.num_points
        self.num_targets = st.num_targets
        self.fine_shape = st.fine_shape
        self.fft_direction = fft_direction
        self.tol = float(tol)
        self.options = options
        dev = self.device

        def planar32(z):
            return torch.as_tensor(
                np.stack([z.real, z.imag], axis=-1).astype(np.float32),
                device=dev)
        self._prephase = planar32(st.prephase)                # [M, 2]
        self._postphase = planar32(st.postphase)              # [K, 2]

        # Outer spread: raw ES-kernel spread onto the type-3 fine grid
        # (spread-only geometry; kernel_scale not applied: the exact
        # kernel-FT deconvolution lives in the postphase).
        self._spread_spec = PlanSpec(
            transform_type="type_1", fft_direction=fft_direction,
            rank=self.rank, grid_shape=self.fine_shape,
            dtype_name="complex64", tol=self.tol, points_range=0,
            spread_only=True, backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self._spread_plan = make_plan(self._spread_spec)
        # xi folded after its float32 cast, as the JAX package folds it.
        xi32 = torch.as_tensor(st.xi.astype(np.float32), device=dev)

        self._spread_level = "none"
        self.geom = self.binned = self.weights = self.coords = None
        margin = 16 * 2 ** 20
        budget = binning.MATS_BYTES_BUDGET
        inner_budget = budget
        geom = binning.choose_geometry(
            self.fine_shape, self._spread_plan.width, self.num_points)
        if (dispatch.route(self._spread_spec, dev) not in FULL_GRID_ROUTES
                and binning.geometry_valid(geom)):
            outer_bytes = binning.mats_payload_bytes(geom)
            inner_plan = make_plan(PlanSpec(
                transform_type="type_2", fft_direction=fft_direction,
                rank=self.rank, grid_shape=self.fine_shape,
                dtype_name="complex64", tol=self.tol, points_range=0,
                spread_only=False, backend=options.backend))
            inner_geom = binning.choose_geometry(
                inner_plan.fine_shape, inner_plan.width, self.num_targets)
            inner_need = (binning.mats_payload_bytes(inner_geom)
                          if (binning.geometry_valid(inner_geom)
                              and binning.mats_supported(inner_geom))
                          else margin)
            outer_ok = binning.mats_supported(geom)
            inner_fits_alone = inner_need <= budget - margin
            if (outer_ok and inner_fits_alone
                    and outer_bytes + inner_need <= budget):
                self._spread_level = "mats"        # both stages fit
            elif (outer_ok and not inner_fits_alone
                    and outer_bytes + margin <= budget):
                # The inner streams coords whatever is left to it; the
                # outer takes the mats.
                self._spread_level = "mats"
            else:
                # Leave the budget to the (dominant) inner stage.
                self._spread_level = "binned"
            used = outer_bytes if self._spread_level == "mats" else margin
            inner_budget = max(budget - used, 1)
            self.geom, self.binned = bin_for_plan(xi32, self._spread_plan,
                                                  geom)
            if self._spread_level == "mats":
                self.weights = binning.build_weight_payload(
                    self.binned, geom, self._spread_plan)
            else:
                self.coords = binning.build_coords_payload(self.binned)
        else:
            self._fine = FineSpread(xi32, self._spread_plan)

        # Inner planned type-2 on the fine grid at the rescaled targets.
        self._inner_t2 = PlannedNufft(
            torch.as_tensor(st.theta.astype(np.float32), device=dev),
            self.fine_shape, transform_type="type_2",
            fft_direction=fft_direction, tol=self.tol, options=options,
            payload_budget_bytes=inner_budget)
        self._adjoint = None

    @property
    def device(self) -> torch.device:
        return self._x.device

    def adjoint(self) -> "Type3Plan":
        """The adjoint type-3 plan: swapped point sets, flipped
        direction (maps values [B, K, 2] back to strengths [B, M, 2])."""
        if self._adjoint is None:
            adj = Type3Plan(
                self._t, self._x,
                fft_direction=("backward"
                               if self.fft_direction == "forward"
                               else "forward"),
                tol=self.tol, options=self.options)
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _spread(self, values_cm: torch.Tensor) -> torch.Tensor:
        """Channel-major values [2B, M] -> planar fine grid [B, *fine, 2]."""
        if self._spread_level == "none":
            return self._fine.spread(values_cm)
        return dispatch.spread(values_cm, self.binned, self.geom,
                               self._spread_plan, kw=self.weights,
                               coords=self.coords)

    def _apply(self, source: torch.Tensor) -> torch.Tensor:
        batch = source.shape[0]
        src = pmul(source, self._prephase)
        with prof.scope("nufft3.spread"):
            grid = self._spread(src.movedim(-1, 1).reshape(
                2 * batch, self.num_points))
        with prof.scope("nufft3.inner_t2"):
            vals = self._inner_t2._apply(grid)            # [B, K, 2]
        return pmul(vals, self._postphase)

    def __call__(self, source) -> torch.Tensor:
        """Applies the transform: planar [B, M, 2] -> [B, K, 2]."""
        source = as_tensor(source, device=self.device)
        if source.dtype != torch.float32:
            raise TypeError(
                f"planar type-3 is float32-only, got "
                f"{str(source.dtype).replace('torch.', '')}.")
        if (source.ndim != 3 or source.shape[-1] != 2
                or source.shape[1] != self.num_points):
            raise ValueError(
                f"planned planar type-3 expects a source of shape "
                f"[B, {self.num_points}, 2]; got {tuple(source.shape)}")
        # Bound fine-grid memory like the complex twin: the spread
        # materializes [B, *fine_shape, 2] before the inner type-2, so
        # chunk the batch at max_batch_size.
        max_bs = self.options.max_batch_size
        if max_bs is None:
            max_bs = auto_max_batch_size(self._inner_t2.plan.spec)
        return chunked_map(lambda s: _Type3Call.apply(s, self), source,
                           max_bs)


class _Type3Call(torch.autograd.Function):
    """A planar type-3 apply whose backward is the adjoint plan's apply:
    the planar-real transpose is the complex adjoint, which swaps the
    point sets and flips the direction (JAX ``_type3_bwd``)."""

    @staticmethod
    def forward(ctx, source, op):
        ctx.op = op
        return op._apply(source.contiguous())

    @staticmethod
    def backward(ctx, cotangent):
        return _Type3Call.apply(cotangent, ctx.op.adjoint()), None


def nufft_type3(source, points, target_points,
                fft_direction: str = "forward", tol: float = 1e-6,
                options: Optional[Options] = None, device=None
                ) -> torch.Tensor:
    """Planar type-3 NUFFT (one-shot): builds a ``Type3Plan`` and applies
    it to ``source`` [B, M, 2]; the planar twin of the top-level
    ``nufft_type3``. The plan is built eagerly, so its inner type-2 is
    banded where a plan built outside any call would be."""
    source, points, target_points = entry_tensors(
        source, points, target_points, device=device)
    return Type3Plan(points, target_points, fft_direction, tol,
                     options)(source)


def nudft_type3(source, points, target_points,
                fft_direction: str = "forward", device=None
                ) -> torch.Tensor:
    """Dense planar type-3 oracle: O(M*K); testing only.

    source [..., M, 2], points [M, rank], target_points [K, rank]
    -> [..., K, 2], in the inputs' precision (no TF32).
    """
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    source, points, target_points = entry_tensors(
        source, points, target_points, device=device)
    sign = -1.0 if fft_direction == "forward" else 1.0
    with _full_precision_matmul():
        phase = target_points @ points.T                  # [K, M]
        cos = torch.cos(phase)
        sin = sign * torch.sin(phase)
        sr, si = source[..., 0], source[..., 1]
        yr = sr @ cos.T - si @ sin.T
        yi = sr @ sin.T + si @ cos.T
    return torch.stack([yr, yi], dim=-1)
