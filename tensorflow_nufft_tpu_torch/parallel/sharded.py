"""Sharded planar NUFFTs over a device mesh, single controller.

Counterpart of ``tensorflow_nufft_tpu.parallel.sharded``. The JAX
package runs each transform as a ``shard_map`` over a ``jax.sharding.
Mesh``; here one process drives the mesh's devices (``parallel.Mesh``),
as JAX's single controller does, and takes and returns global tensors:

  - **data axis**: the batch (coils) splits into contiguous blocks; no
    communication.
  - **points axis**: the nonuniform points split into contiguous
    blocks. Type-2 evaluates each block from the replicated grid;
    type-1 spreads each block and sums the blocks' outputs (the JAX
    ``psum``).

Mesh coordinate (i, j) gets the i-th batch block and the j-th points
(or grid-slab) block, JAX's ``P(data, points)`` blocks, sliced from the
global input and moved ``.to`` the device at that coordinate. Each block
runs the port's unsharded core of the same kind, so the blocks launch
the hand-written kernels on the card and their plain versions on the
CPU. The two collectives are ``_psum`` (the sum of the blocks on one
device) and ``_all_gather`` (a concatenation). ``.to``, ``cat`` and the
sum are differentiable, so the gradients come from the per-block cores'
own backward passes.

Deliberate differences from the JAX package:
  - a mesh axis that is neither the data nor the points (or grid) axis
    is replicated: its blocks would compute the same result, so each is
    computed once, on the first device along that axis;
  - outputs are global tensors on the device of ``source`` (JAX's stay
    laid out over the mesh), so on several cards the blocks' outputs
    are copied there;
  - no ``shard_map`` varying-axes bookkeeping (``_vary_over``,
    ``_planned_vma_check``): there is no checker to satisfy.

Everything is planar-real (see ``tensorflow_nufft_tpu_torch.planar``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.fft.planar_fft import (
    _contract_planar, _mode_twiddles)
from tensorflow_nufft_tpu_torch.kernels.binning import BandInfo
from tensorflow_nufft_tpu_torch.ops.nufft_ops import (
    VALID_FFT_DIRECTIONS, VALID_TRANSFORM_TYPES, _canonical_grid_shape,
    _validate_enum)
from tensorflow_nufft_tpu_torch.ops.planar_core import nufft_core_planar
from tensorflow_nufft_tpu_torch.ops.type3 import (
    FineSpread, _FineSpreadCall, compute_type3_statics,
    validate_type3_point_sets)
from tensorflow_nufft_tpu_torch.options.options import Options
from tensorflow_nufft_tpu_torch.parallel.mesh import Mesh
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
from tensorflow_nufft_tpu_torch.planar import (
    PlannedNufft, _check_planar_inputs, _check_rank, pmul)
from tensorflow_nufft_tpu_torch.utils.batching import chunked_map
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    as_tensor, dtype_name, entry_tensors)


# ---------------------------------------------------------------------------
# Blocks and collectives.
# ---------------------------------------------------------------------------


def _make_spec(transform_type, fft_direction, rank, grid_shape, dtype,
               tol, options: Options) -> PlanSpec:
    return PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=tuple(int(d) for d in grid_shape),
        dtype_name=dtype_name(dtype),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=False,
        upsampling_factor=options.upsampling_factor,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )


def _axis(mesh: Mesh, name: Optional[str]) -> Optional[str]:
    """``name`` where the mesh has that axis, else None (a name not in
    the mesh counts as None, as in the JAX package)."""
    return name if name and name in mesh.axis_names else None


def _size(mesh: Mesh, axis: Optional[str]) -> int:
    return mesh.shape[axis] if axis else 1


def _entry(mesh: Mesh, *xs):
    """The global inputs as tensors: tensors stay where they are; numpy
    arrays and lists go to the device of the first tensor among ``xs``,
    or to the mesh's first device where there is none."""
    if any(isinstance(x, torch.Tensor) for x in xs):
        return entry_tensors(*xs)
    return entry_tensors(*xs, device=mesh.devices.flat[0])


def _split(x: torch.Tensor, sizes, dim: int) -> Tuple[torch.Tensor, ...]:
    """Contiguous blocks of ``x`` along ``dim``: ``sizes`` equal blocks
    (an int; the caller checked that it divides), or blocks of the
    listed sizes."""
    if isinstance(sizes, int):
        if sizes == 1:
            return (x,)
        sizes = x.shape[dim] // sizes
    return torch.split(x, sizes, dim=dim)


def _psum(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The points-axis ``psum``: the blocks' sum, in block order, on
    ``device``."""
    total = blocks[0].to(device)
    for block in blocks[1:]:
        total = total + block.to(device)
    return total


def _all_gather(blocks: Sequence[torch.Tensor], device, dim: int
                ) -> torch.Tensor:
    """The tiled ``all_gather``: the blocks concatenated along ``dim`` on
    ``device`` (also how block outputs assemble into a global tensor)."""
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def _blocks(row: torch.Tensor, devices: Sequence[torch.device],
            fn: Callable[[torch.Tensor, int], torch.Tensor], split,
            reduce: bool, out_dev) -> torch.Tensor:
    """One data row over the points (or grid) axis: part j of ``row``
    (dim 1 in ``split`` parts, see ``_split``; the whole row where
    ``split`` is None) goes ``.to(devices[j])`` and through
    ``fn(part, j)``. The outputs are summed on ``out_dev`` with
    ``reduce`` (the psum), else concatenated there on dim 1."""
    parts = (_split(row, split, 1) if split is not None
             else (row,) * len(devices))
    outs = [fn(part.to(dev), j)
            for j, (part, dev) in enumerate(zip(parts, devices))]
    return _psum(outs, out_dev) if reduce else _all_gather(outs, out_dev, 1)


def _rows(source: torch.Tensor, nd: int,
          fn: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """``fn(row, i)`` on each of the ``nd`` data-axis blocks of
    ``source`` (dim 0), concatenated in order."""
    _check_divides(int(source.shape[0]), nd, "batch", "data axis")
    return torch.cat([fn(row, i)
                      for i, row in enumerate(_split(source, nd, 0))], dim=0)


def _check_divides(n: int, size: int, what: str, axis_label: str) -> None:
    if n % size:
        raise ValueError(f"{what} {n} must divide evenly over the "
                         f"{axis_label} (size {size})")


def _check_source_shape(source, transform_type, num_points, grid_shape,
                        what="sharded"):
    """The JAX message for a source of the wrong shape."""
    if transform_type == "type_1":
        ok = (source.ndim == 3 and source.shape[1] == num_points
              and source.shape[-1] == 2)
        expect = f"[B, {num_points}, 2]"
    else:
        ok = (source.ndim == len(grid_shape) + 2
              and tuple(source.shape[1:-1]) == tuple(grid_shape)
              and source.shape[-1] == 2)
        expect = "[B, {}, 2]".format(", ".join(str(g) for g in grid_shape))
    if not ok:
        raise ValueError(
            f"{what} {transform_type} expects a source of shape {expect}; "
            f"got {tuple(source.shape)}")


def _global_inputs(mesh, source, points):
    """Entry tensors with the points on the source's device, checked as
    the planar API checks them; points must be one [M, rank] set."""
    source, points = _entry(mesh, source, points)
    points = points.to(source.device)
    _check_planar_inputs(source, points)
    if points.ndim != 2:
        raise ValueError(
            f"sharded transforms take a single [M, rank] point set, got "
            f"shape {tuple(points.shape)}")
    _check_rank(int(points.shape[-1]))
    return source, points


# ---------------------------------------------------------------------------
# The functional transforms.
# ---------------------------------------------------------------------------


def sharded_nufft(source,
                  points,
                  mesh: Mesh,
                  grid_shape: Optional[Tuple[int, ...]] = None,
                  transform_type: str = "type_2",
                  fft_direction: str = "forward",
                  tol: float = 1e-6,
                  options: Optional[Options] = None,
                  data_axis: Optional[str] = "data",
                  points_axis: Optional[str] = "points") -> torch.Tensor:
    """Planar NUFFT sharded over a device mesh.

    Args:
        source: planar complex. Type-2: ``[B, *grid, 2]``; type-1:
            ``[B, M, 2]``. ``B`` splits over ``data_axis``, ``M`` over
            ``points_axis``. Both axes optional (None, or a name not in
            the mesh, skips one).
        points: ``[M, rank]``, split over ``points_axis``, replicated
            over ``data_axis``.
        mesh: the device mesh; axis sizes must divide B and M.
        grid_shape: required for type-1.

    Returns:
        Type-2 ``[B, M, 2]``, type-1 ``[B, *grid, 2]``, on the device of
        ``source``. Differentiable in ``source`` and ``points`` (each
        block's ``nufft_core_planar``).
    """
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    options = options or Options()
    source, points = _global_inputs(mesh, source, points)
    rank, m = int(points.shape[-1]), int(points.shape[0])
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = _canonical_grid_shape(grid_shape)
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {grid_shape}")
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
    _check_source_shape(source, transform_type, m, grid_shape)
    spec = _make_spec(transform_type, fft_direction, rank, grid_shape,
                      points.dtype, tol, options)

    da, pa = _axis(mesh, data_axis), _axis(mesh, points_axis)
    nd, npts = _size(mesh, da), _size(mesh, pa)
    _check_divides(m, npts, "num_points", "points axis")
    pts_blocks = _split(points, npts, 0)
    type_1 = transform_type == "type_1"

    def row(x, i):
        # Type-1: each block spreads only its points; the (already
        # deconvolved) mode outputs sum, the JAX psum. Type-2: the
        # blocks' points are consecutive slices of M.
        return _blocks(
            x, [mesh.device_at({da: i, pa: j}) for j in range(npts)],
            lambda part, j: nufft_core_planar(
                part, pts_blocks[j].to(part.device), spec),
            npts if type_1 else None, type_1, source.device)
    return _rows(source, nd, row)


def sharded_nufft_grid(source,
                       points,
                       mesh: Mesh,
                       grid_shape: Optional[Tuple[int, ...]] = None,
                       transform_type: str = "type_2",
                       fft_direction: str = "forward",
                       tol: float = 1e-6,
                       options: Optional[Options] = None,
                       grid_axis: str = "grid") -> torch.Tensor:
    """NUFFT with the mode grid's leading dimension split over
    ``grid_axis`` (single-large-transform scaling):

      - type-1: every block spreads all points onto its own fine grid
        and computes only its slab of the mode grid: the row-pruned
        twiddle contraction of the leading axis (fused DFT, truncation
        and deconvolution), then the full contraction of the others;
      - type-2: the mode slabs are gathered (``_all_gather``) and each
        block evaluates its share of the points.

    Args:
        source: type-1 ``[B, M, 2]`` (replicated); type-2
            ``[B, *grid, 2]``, split on grid dim 0.
        points: ``[M, rank]``; replicated for type-1, split over
            ``grid_axis`` for type-2.

    Returns:
        type-1 ``[B, *grid, 2]``; type-2 ``[B, M, 2]``, on the device of
        ``source``. Differentiable in ``source``; type-2 also in
        ``points``. The type-1 points are plan data.
    """
    transform_type = _validate_enum(
        transform_type, VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    options = options or Options()
    source, points = _global_inputs(mesh, source, points)
    rank, m = int(points.shape[-1]), int(points.shape[0])
    ndev = mesh.shape[grid_axis]
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = _canonical_grid_shape(grid_shape)
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {grid_shape}")
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
    _check_source_shape(source, transform_type, m, grid_shape)
    if grid_shape[0] % ndev != 0:
        raise ValueError(
            f"the '{grid_axis}' mesh axis size {ndev} must divide the "
            f"leading grid dim {grid_shape[0]}")
    spec = _make_spec(transform_type, fft_direction, rank, grid_shape,
                      points.dtype, tol, options)
    out_dev = source.device
    devices = [mesh.device_at({grid_axis: j}) for j in range(ndev)]

    if transform_type == "type_1":
        if points.requires_grad:
            raise ValueError(
                "sharded_nufft_grid type-1 takes its points as plan data "
                "(each block bins them); pass points.detach(), or use "
                "sharded_nufft for a points gradient")
        plan = make_plan(spec)
        sign = -1.0 if fft_direction == "forward" else 1.0
        slab = grid_shape[0] // ndev
        twiddles = [_mode_twiddles(plan.fine_shape[d], grid_shape[d], sign,
                                   plan.deconv_weights(d), truncating=True)
                    for d in range(rank)]
        # Per device, once a call: the raw spread of all points (binned
        # there) and the twiddles in the points' dtype.
        per_dev = {}

        def slab_of(x, j):
            dev = devices[j]
            if dev not in per_dev:
                per_dev[dev] = (
                    FineSpread(points.detach().to(dev), plan),
                    [tuple(torch.as_tensor(mat, device=dev).to(points.dtype)
                           for mat in cs) for cs in twiddles])
            spread, mats = per_dev[dev]
            # No kernel_scale (the deconvolution weights are in the
            # twiddles); differentiable in the strengths: its transpose
            # is the interp.
            fine = _FineSpreadCall.apply(x, spread)
            xr, xi = fine[..., 0], fine[..., 1]
            for d, (c, s) in enumerate(mats):
                if d == 0:     # this block's rows of the leading axis
                    c, s = (c[:, j * slab:(j + 1) * slab],
                            s[:, j * slab:(j + 1) * slab])
                xr, xi = _contract_planar(xr, xi, c, s, 1 + d)
            return torch.stack([xr, xi], dim=-1)     # [B, slab, .., 2]
        return _blocks(source, devices, slab_of, None, False, out_dev)

    _check_divides(m, ndev, "num_points", f"'{grid_axis}' axis")
    pts_blocks = _split(points, ndev, 0)
    # The all_gather of the mode slabs: every block takes the whole grid.
    return _blocks(source, devices, lambda x, j: nufft_core_planar(
        x, pts_blocks[j].to(x.device), spec), None, False, out_dev)


def sharded_nufft_type3(source,
                        points,
                        target_points,
                        mesh: Mesh,
                        fft_direction: str = "forward",
                        tol: float = 1e-6,
                        options: Optional[Options] = None,
                        data_axis: Optional[str] = "data",
                        points_axis: Optional[str] = "points"
                        ) -> torch.Tensor:
    """Planar type-3 NUFFT sharded over a device mesh.

    One ``points_axis`` splits both nonuniform sides: each block
    prephases and spreads its source points onto the type-3 fine grid,
    one ``_psum`` reduces the grid, and each block evaluates its block
    of the target frequencies with an inner type-2 and postphases them.
    ``data_axis`` splits the strength batch.

    Args:
        source: planar strengths ``[B, M, 2]`` (float32).
        points: ``[M, rank]`` float32, concrete (plan statics); the
            ``points_axis`` size must divide ``M``.
        target_points: ``[K, rank]`` float32, concrete; the size must
            divide ``K``.
        mesh: the device mesh.

    Returns:
        ``[B, K, 2]`` planar values on the device of ``source``;
        differentiable in ``source``.
    """
    fft_direction = _validate_enum(
        fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
    options = options or Options()
    x, t = validate_type3_point_sets(points, target_points,
                                     allowed_dtypes=(np.float32,))
    st = compute_type3_statics(
        np.asarray(x, np.float64), np.asarray(t, np.float64),
        fft_direction, tol, real_dt=np.float32)

    da, pa = _axis(mesh, data_axis), _axis(mesh, points_axis)
    nd, npts = _size(mesh, da), _size(mesh, pa)
    if st.num_points % npts or st.num_targets % npts:
        raise ValueError(
            f"the '{points_axis}' mesh axis size {npts} must divide "
            f"both M={st.num_points} and K={st.num_targets}")
    source, = _entry(mesh, source)
    if source.dtype != torch.float32:
        raise TypeError(
            f"planar type-3 is float32-only, got "
            f"{str(source.dtype).replace('torch.', '')}.")
    if (source.ndim != 3 or source.shape[-1] != 2
            or source.shape[1] != st.num_points):
        raise ValueError(
            f"sharded planar type-3 expects a source of shape "
            f"[B, {st.num_points}, 2]; got {tuple(source.shape)}")

    spread_spec = PlanSpec(
        transform_type="type_1", fft_direction=fft_direction,
        rank=st.rank, grid_shape=st.fine_shape, dtype_name="complex64",
        tol=float(tol), points_range=0, spread_only=True,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method)
    spread_plan = make_plan(spread_spec)
    if (spread_plan.width != st.width
            or spread_plan.fine_shape != st.fine_shape):
        raise AssertionError(
            "type-3 spread plan geometry mismatch (statics vs plan); "
            "see ops/type3.py compute_type3_statics tol clamping")
    t2_spec = PlanSpec(
        transform_type="type_2", fft_direction=fft_direction,
        rank=st.rank, grid_shape=st.fine_shape, dtype_name="complex64",
        tol=float(tol), points_range=0, backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method)

    def planar32(z):
        return torch.from_numpy(
            np.stack([z.real, z.imag], axis=-1).astype(np.float32))
    xi_blocks = _split(torch.from_numpy(st.xi.astype(np.float32)), npts, 0)
    pre_blocks = _split(planar32(st.prephase), npts, 0)          # [M, 2]
    theta_blocks = _split(torch.from_numpy(st.theta.astype(np.float32)),
                          npts, 0)
    post_blocks = _split(planar32(st.postphase), npts, 0)        # [K, 2]
    out_dev = source.device

    devices = [[mesh.device_at({da: i, pa: j}) for j in range(npts)]
               for i in range(nd)]
    # The spread of points block j, binned once on each device it runs.
    fines = {}
    for row in devices:
        for j, dev in enumerate(row):
            if (dev, j) not in fines:
                fines[(dev, j)] = FineSpread(xi_blocks[j].to(dev), spread_plan)

    def one_row(x, i):
        devs = devices[i]
        # Each block spreads only its points: the fine grids sum over the
        # points axis (linear, so summing the raw spreads is exact).
        grid = _blocks(x, devs, lambda part, j: _FineSpreadCall.apply(
            pmul(part, pre_blocks[j].to(part.device)), fines[(devs[j], j)]),
            npts, True, out_dev)
        return _blocks(grid, devs, lambda g, j: pmul(
            nufft_core_planar(g, theta_blocks[j].to(g.device), t2_spec),
            post_blocks[j].to(g.device)), None, False, out_dev)

    # Honor the user's max_batch_size on each block's batch (fine-grid
    # memory bound, like the plan APIs), only where set explicitly.
    max_bs = options.max_batch_size
    return _rows(source, nd, lambda row, i: (
        one_row(row, i) if max_bs is None
        else chunked_map(lambda s: one_row(s, i), row, max_bs)))


# ---------------------------------------------------------------------------
# Planned + sharded: the iterative-reconstruction path.
# ---------------------------------------------------------------------------


def _moved(x, device):
    """``x`` with every tensor in it (also inside tuples and named
    tuples) moved to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [_moved(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _plan_on(plan: PlannedNufft, device: torch.device) -> PlannedNufft:
    """A copy of a planned shard with all its tensors on ``device`` (made
    once, at construction, for a data row on another device): the same
    slots and band, so every data row reads one slot order."""
    out = object.__new__(PlannedNufft)
    out.__dict__.update({k: _moved(v, device)
                         for k, v in plan.__dict__.items()})
    out._adjoint = None
    return out


class ShardedPlannedNufft:
    """Planned planar NUFFT over a device mesh.

    Combines the planned pipeline (``planar.PlannedNufft``: binning,
    windows or coords hoisted to plan time) with sharded execution: the
    batch (coils) splits over ``data_axis`` and the point set over
    ``points_axis``. Points block j has its own plan, built on the device
    of block (0, j); a data row on other devices gets a copy of the
    plan's tensors there, made once here. Type-1 sums the blocks'
    (deconvolved) mode outputs over the points axis; type-2 needs no
    collective.

    Where every block planned onto one geometry, the plans of a rank-3
    "binned" level take one band height, the largest of the blocks' (the
    JAX package's uniform band): each block's band origins are re-clipped
    to it (coverage only grows). Where some block has no band, none keeps
    one. A block whose own band the memory model rejected re-plans on the
    unbanded geometry; the blocks' geometries then differ, and each block
    keeps its own plan and band (the JAX package, which stacks the
    blocks' artifacts into one call, asserts one geometry there).

    Differentiable in ``source`` (each block's ``PlannedNufft`` call and
    its adjoint). Falls back to the unplanned ``sharded_nufft`` where a
    block's plan is at level "none" (float64, ``backend='xla'`` or
    ``'native'``).

    Args:
        points: ``[M, rank]`` radians in ``[-pi, pi]``; the points-axis
            size must divide ``M``. Plan data (no gradient).
        grid_shape: the mode grid.
        mesh: the device mesh.
        data_axis / points_axis: mesh axis names (None, or a name not in
            the mesh, skips one).

    Apply: type-2 ``[B, *grid, 2] -> [B, M, 2]``; type-1
    ``[B, M, 2] -> [B, *grid, 2]``; the data-axis size must divide
    ``B``. Outputs on the device of the source.
    """

    def __init__(self, points, grid_shape, mesh: Mesh,
                 transform_type: str = "type_2",
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None,
                 data_axis: Optional[str] = "data",
                 points_axis: Optional[str] = "points"):
        transform_type = _validate_enum(
            transform_type, VALID_TRANSFORM_TYPES, "transform_type")
        fft_direction = _validate_enum(
            fft_direction, VALID_FFT_DIRECTIONS, "fft_direction")
        self.mesh = mesh
        self.data_axis = _axis(mesh, data_axis)
        self.points_axis = _axis(mesh, points_axis)
        pa = self.points_axis
        points, = _entry(mesh, points)
        if points.ndim != 2:
            raise ValueError(
                f"planned transforms take a single [M, rank] point "
                f"set, got shape {tuple(points.shape)}")
        s = _size(mesh, pa)
        m = int(points.shape[0])
        if m % s:
            raise ValueError(
                f"num_points {m} must divide evenly over the "
                f"points axis (size {s})")
        self.points = points
        self.num_points = m
        self._num_shards = s
        shards = [PlannedNufft(block.to(mesh.device_at({pa: j})),
                               grid_shape, transform_type=transform_type,
                               fft_direction=fft_direction, tol=tol,
                               options=options)
                  for j, block in enumerate(_split(points, s, 0))]
        self._shards = shards
        p0 = shards[0]
        self.grid_shape = p0.grid_shape
        self.transform_type = transform_type
        self.fft_direction = fft_direction
        self.tol = p0.tol
        self.options = p0.options
        self._adjoint = None
        self._planned = all(sh.level != "none" for sh in shards)
        self.level = p0.level if self._planned else "none"
        self._band = None
        if not self._planned:
            return
        self.plan = p0.plan
        self.geom = p0.geom     # every block's, where they agree
        uniform = all(sh.geom == p0.geom and sh.level == p0.level
                      for sh in shards)
        if self.level == "binned" and uniform:
            bands = [sh.band_info for sh in shards]
            if all(b is not None for b in bands):
                self._band = max(b.band for b in bands)
            e0 = self.geom.ext[0]
            for sh, b in zip(shards, bands):
                sh.band_info = None if self._band is None else BandInfo(
                    self._band, b.zorigins.clamp(max=e0 - self._band))
        # The plan of block (i, j): shard j's, on the device at (i, j).
        self._plans = {}
        for i in range(_size(mesh, self.data_axis)):
            for j, sh in enumerate(shards):
                dev = mesh.device_at({self.data_axis: i, pa: j})
                self._plans[(i, j)] = (sh if dev == sh.device
                                       else _plan_on(sh, dev))

    # -- plumbing -----------------------------------------------------

    def adjoint(self) -> "ShardedPlannedNufft":
        """The adjoint planned transform (swapped type and direction),
        sharing all per-shard points-side artifacts."""
        if self._adjoint is None:
            adj = object.__new__(ShardedPlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            adj._shards = [sh.adjoint() for sh in self._shards]
            if self._planned:
                adj.plan = adj._shards[0].plan
                adj._plans = {k: p.adjoint() for k, p in self._plans.items()}
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _source(self, source) -> torch.Tensor:
        """``source`` as a tensor: numpy input goes to the points'
        device."""
        if isinstance(source, torch.Tensor):
            return source
        return as_tensor(source, device=self.points.device)

    def _slot_sizes(self) -> List[int]:
        return [sh.num_slots for sh in self._shards]

    def _run(self, source: torch.Tensor,
             fn: Callable[[PlannedNufft, torch.Tensor, int], torch.Tensor],
             split: Optional[Sequence[int]], reduce: bool) -> torch.Tensor:
        """Runs ``fn(plan, block, j)`` on every block (i, j) and
        assembles a global tensor on the source's device: the input
        splits over the data axis on dim 0 and, with ``split`` (the
        points-axis sizes), over the points axis on dim 1, else it is
        replicated there; the blocks' outputs are summed over the points
        axis with ``reduce`` (``_psum``), else concatenated on dim 1."""
        def row(x, i):
            plans = [self._plans[(i, j)] for j in range(self._num_shards)]
            return _blocks(x, [p.device for p in plans],
                           lambda part, j: fn(plans[j], part, j),
                           split, reduce, source.device)
        return _rows(source, _size(self.mesh, self.data_axis), row)

    def _points_split(self) -> List[int]:
        return [self.num_points // self._num_shards] * self._num_shards

    # -- applies ------------------------------------------------------

    def __call__(self, source) -> torch.Tensor:
        """Applies the transform to planar ``source`` (see class doc)."""
        source = self._source(source)
        _check_source_shape(source, self.transform_type, self.num_points,
                            self.grid_shape, what="sharded planned")
        if not self._planned:
            return sharded_nufft(
                source, self.points, self.mesh,
                grid_shape=self.grid_shape,
                transform_type=self.transform_type,
                fft_direction=self.fft_direction, tol=self.tol,
                options=self.options, data_axis=self.data_axis,
                points_axis=self.points_axis)
        type_1 = self.transform_type == "type_1"
        return self._run(source, lambda p, x, j: p(x),
                         self._points_split() if type_1 else None,
                         reduce=type_1)

    # -- fused normal operator ----------------------------------------

    def slot_weights(self, weights) -> torch.Tensor:
        """Per-point real weights [M] -> shard-major chunk-slot order
        ([s*S] on the points' device, the layout of ``slot_mask``; the
        JAX package stacks them [s, S]) for ``normal``; point order must
        match the constructor's ``points``."""
        w = as_tensor(weights, device=self.points.device)
        if tuple(w.shape) != (self.num_points,):
            raise ValueError(
                f"weights must have shape [{self.num_points}], got "
                f"{tuple(w.shape)}")
        if not self._planned:
            return w
        ws = _split(w, self._num_shards, 0)
        return torch.cat([sh.slot_weights(ws[j]).to(w.device)
                          for j, sh in enumerate(self._shards)])

    def normal(self, source, slot_w=None) -> torch.Tensor:
        """The normal operator ``A^H W A`` over the mesh: on each block
        the type-2 apply and its adjoint with the point values kept in
        slot order (``PlannedNufft.normal``), then one sum of the mode
        outputs over the points axis. ``slot_w`` comes from
        ``slot_weights`` (plan data, no gradient).

        [B, *grid, 2] -> [B, *grid, 2]; its gradient is itself applied
        to the cotangent (the operator is self-adjoint).
        """
        source = self._source(source)
        if not self._planned:
            t2 = self if self.transform_type == "type_2" \
                else self.adjoint()
            vals = t2(source)
            if slot_w is not None:
                vals = vals * as_tensor(slot_w, device=vals.device).to(
                    vals.dtype).detach()[None, :, None]
            return t2.adjoint()(vals)
        blocks = (None if slot_w is None
                  else _split(as_tensor(slot_w), self._slot_sizes(), 0))
        return self._run(
            source, lambda p, x, j: p.normal(
                x, None if blocks is None else blocks[j]),
            None, reduce=True)

    # -- chunk-slot-order apply surface -------------------------------
    # Per-point vectors in shard-major chunk-slot order ([B, s*S, 2]:
    # each shard's S slots in turn), so iterative pipelines skip the
    # per-call point-order gathers of every block. Convert loop-invariant
    # data once with ``to_slots``.

    @property
    def num_slots(self) -> int:
        """Global slot-axis length (shard-major: ``s * S_shard``)."""
        if not self._planned:
            return int(self.num_points)
        return sum(self._slot_sizes())

    @property
    def slot_mask(self) -> torch.Tensor:
        """[s*S] in the points' dtype; 1 where the slot holds a real
        point."""
        if not self._planned:
            return torch.ones(self.num_points, dtype=self.points.dtype,
                              device=self.points.device)
        return torch.cat([sh.slot_mask.to(self.points.device)
                          for sh in self._shards])

    def _check_slot_shape(self, x, what):
        s = self.num_slots
        if not (x.ndim == 3 and x.shape[1] == s and x.shape[-1] == 2):
            raise ValueError(
                f"{what} expects [B, {s}, 2] shard-major slot-order "
                f"values, got shape {tuple(x.shape)}")

    def to_slots(self, values) -> torch.Tensor:
        """Point-order planar values [B, M, 2] -> shard-major slot
        order [B, s*S, 2] (zeros in padded/unused slots); point order
        must match the constructor's ``points``. Its gradient is
        ``from_slots``."""
        values = self._source(values)
        m = int(self.num_points)
        if not (values.ndim == 3 and values.shape[1] == m
                and values.shape[-1] == 2):
            raise ValueError(
                f"to_slots expects [B, {m}, 2] planar values, got "
                f"shape {tuple(values.shape)}")
        if not self._planned:
            return values
        return self._run(values, lambda p, x, j: p.to_slots(x),
                         self._points_split(), reduce=False)

    def from_slots(self, slot_values) -> torch.Tensor:
        """Shard-major slot order [B, s*S, 2] -> point order
        [B, M, 2] (the inverse of ``to_slots``, and its gradient)."""
        slot_values = self._source(slot_values)
        if not self._planned:
            return slot_values
        self._check_slot_shape(slot_values, "from_slots")
        return self._run(slot_values, lambda p, x, j: p.from_slots(x),
                         self._slot_sizes(), reduce=False)

    def apply_to_slots(self, source) -> torch.Tensor:
        """Type-2 apply producing shard-major slot-order values
        [B, s*S, 2]: no point-order gather in any block. Differentiable
        in ``source``."""
        if self.transform_type != "type_2":
            raise ValueError(
                "apply_to_slots is the type-2 (grid -> points) apply; "
                "this plan is type_1 (use adjoint(), or "
                "apply_from_slots)")
        source = self._source(source)
        rank = len(self.grid_shape)
        if not (source.ndim == rank + 2
                and tuple(source.shape[1:-1]) == self.grid_shape
                and source.shape[-1] == 2):
            raise ValueError(
                f"apply_to_slots expects [B, "
                f"{', '.join(str(g) for g in self.grid_shape)}, 2], "
                f"got shape {tuple(source.shape)}")
        if not self._planned:
            return self(source)
        return self._run(source, lambda p, x, j: p.apply_to_slots(x),
                         None, reduce=False)

    def apply_from_slots(self, slot_values) -> torch.Tensor:
        """Type-1 apply from shard-major slot-order values [B, s*S, 2]
        -> grid [B, *grid, 2] (one sum over the points axis; padded and
        unused slots masked out). Differentiable."""
        if self.transform_type != "type_1":
            raise ValueError(
                "apply_from_slots is the type-1 (points -> grid) "
                "apply; this plan is type_2 (use adjoint(), or "
                "apply_to_slots)")
        slot_values = self._source(slot_values)
        if not self._planned:
            return self(slot_values)
        self._check_slot_shape(slot_values, "apply_from_slots")
        return self._run(slot_values,
                         lambda p, x, j: p.apply_from_slots(x),
                         self._slot_sizes(), reduce=True)
