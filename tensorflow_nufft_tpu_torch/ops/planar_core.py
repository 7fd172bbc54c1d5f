"""Planar-real core NUFFT: one point set, an inner batch of transforms.

Counterpart of ``tensorflow_nufft_tpu.ops.planar_core``. Every tensor is
real with a trailing (re, im) channel; the spread/interp stages are
real-linear and channel-independent, so the channel folds into the batch
axis with row order (b, re/im).

Gradients (``torch.autograd.Function``s, the JAX package's custom VJPs):
planar tensors are real, so PyTorch's gradient is JAX's real transpose,
the planar form of the complex adjoint. The source gradient of a
transform is the adjoint transform (swapped type and direction); its
points gradient is a type-2 of the mode-weighted grid side over
``batch * rank`` transforms, contracted with the point side. Both are
written with the differentiable cores themselves, so a transform has a
second derivative. The spread-only ops' source gradient is the swapped
op and their points gradient the derivative-kernel interp
(``dispatch.interp_deriv``), which has no gradient of its own.

Each transform takes the route of ``dispatch.route``: the tiled kernels
(or their plain versions), or, for float64 on the card and
``backend='xla'``, the JAX package's XLA path in torch ops
(``_execute_xla``), on the complex view of the planar tensors; with
``backend='native'`` the same path with the native engine's spread and
interp (the JAX package's host callbacks). The spread-only ops' points
gradients take the XLA-path ops there: the engine has no derivative
kernel, as in the JAX package.

Each stage runs in a ``utils.profiling.scope`` span of its JAX name:
``nufft.fold_rescale``, ``nufft.spread``, ``nufft.mode_dft_deconvolve``,
``nufft.amplify_dft`` and ``nufft.interp`` on the tiled route (the JAX
planar core's), ``nufft.fft``, ``nufft.deconvolve`` and
``nufft.amplify`` in their place on the XLA path and the native engine
(the JAX complex core's). The binning of ``bin_for_plan`` runs under
``prep.bin``, inside ``nufft.fold_rescale`` on a transform's path: the
port's own name, not a JAX scope.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tensorflow_nufft_tpu_torch.fft.fft_ops import (
    amplify, deconvolve, fft_fine)
from tensorflow_nufft_tpu_torch.fft.planar_fft import (
    amplify_pad_dft_tiled, dft_truncate_deconvolve_tiled)
from tensorflow_nufft_tpu_torch.kernels import binning, dispatch, xla_ops
from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
    fold_and_rescale_split)
from tensorflow_nufft_tpu_torch.ops.core import _mode_grid, _replace
from tensorflow_nufft_tpu_torch.plan.plan import (
    PlanSpec, check_fine_grid_size, make_plan)
from tensorflow_nufft_tpu_torch.utils import profiling as prof

# The routes that run the XLA path's full-grid pipeline (_execute_xla).
FULL_GRID_ROUTES = ("xla", "native")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, *elem, 2] -> [2B, *elem] (channel becomes fastest batch dim)."""
    return x.movedim(-1, 1).reshape((x.shape[0] * 2,) + x.shape[1:-1])


def _unfold(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[2B, *elem] -> [B, *elem, 2]."""
    return x.reshape((batch, 2) + x.shape[1:]).movedim(1, -1)


def bin_for_plan(points: torch.Tensor, plan,
                 geom: Optional[binning.TileGeometry] = None,
                 zorder: bool = False):
    """Points-side preprocessing: two-float fold, tile geometry (the
    unbanded ``choose_geometry`` unless ``geom`` is given) and binning
    (z-ordered with ``zorder``), the binning under the ``prep.bin`` span.
    Returns (geom, binned)."""
    if geom is None:
        geom = binning.choose_geometry(plan.fine_shape, plan.width,
                                       int(points.shape[0]))
    if not binning.geometry_valid(geom):
        raise ValueError(
            f"cannot tile fine shape {plan.fine_shape}: a dim is smaller "
            f"than twice the halo {geom.pad}")
    points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                         plan.spec.points_range)
    with prof.scope("prep.bin"):
        return geom, binning.bin_points(points_resc, geom, zorder=zorder)


def _execute_planar(source: torch.Tensor, points: torch.Tensor,
                    plan) -> torch.Tensor:
    """source: [B, M, 2] (type-1) or [B, *grid, 2] (type-2); points:
    [M, rank]. Returns the planar output."""
    spec = plan.spec
    source = source.contiguous()
    batch = source.shape[0]
    check_fine_grid_size(plan, 2 * batch)    # planar: re/im channel pair
    route = dispatch.route(spec, source.device)
    if route in FULL_GRID_ROUTES:
        return _execute_xla(source, points, plan, route)
    with prof.scope("nufft.fold_rescale"):
        geom, binned = bin_for_plan(points, plan)
    if spec.transform_type == "type_1":
        if spec.spread_only:
            with prof.scope("nufft.spread"):
                fine = dispatch.spread(_fold(source), binned, geom, plan)
            return fine * plan.kernel_scale
        with prof.scope("nufft.spread"):
            tiles = dispatch.spread_tiled(_fold(source), binned, geom, plan)
        with prof.scope("nufft.mode_dft_deconvolve"):
            return dft_truncate_deconvolve_tiled(tiles, plan, geom, batch)
    if spec.spread_only:
        with prof.scope("nufft.interp"):
            values = dispatch.interp(source, binned, geom, plan)
        return _unfold(values, batch) * plan.kernel_scale
    with prof.scope("nufft.amplify_dft"):
        tiles = amplify_pad_dft_tiled(source, plan, geom)
    with prof.scope("nufft.interp"):
        values = dispatch.interp_tiled(tiles, binned, geom, plan)
    return _unfold(values, batch)


def full_grid_windows(points_resc, plan, route: str):
    """What a full-grid route's spread and interp read of the points:
    the native engine's float64 host points, or the XLA-path window
    indices and values (``xla_ops.spread_geometry``)."""
    if route == "native":
        return dispatch.host_points(points_resc)
    return xla_ops.spread_geometry(points_resc, plan)


def spread_full(values: torch.Tensor, windows, plan,
                route: str) -> torch.Tensor:
    """Complex values [B, M] -> complex fine grid [B, *fine] on a full-grid
    route, from ``full_grid_windows``: the native engine, or the XLA-path
    ops (the JAX package's ``dispatch.spread`` off the Pallas kernels)."""
    if route == "native":
        return dispatch.native_spread(values, windows, plan)
    return xla_ops.spread_xla(values, *windows, plan)


def interp_full(grid: torch.Tensor, windows, plan,
                route: str) -> torch.Tensor:
    """Complex fine grid [B, *fine] -> complex values [B, M] on a
    full-grid route (``spread_full``'s transpose)."""
    if route == "native":
        return dispatch.native_interp(grid, windows, plan)
    return xla_ops.interp_xla(grid, *windows, plan)


def _execute_xla(source: torch.Tensor, points: torch.Tensor,
                 plan, route: str = "xla") -> torch.Tensor:
    """``_execute_planar`` on a full-grid route (``spread_full``): the
    JAX package's ``ops.core._execute`` on the complex view of
    ``source``."""
    spec = plan.spec
    z = torch.view_as_complex(source)
    with prof.scope("nufft.fold_rescale"):
        points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                             spec.points_range)
    if spec.transform_type == "type_1":
        with prof.scope("nufft.spread"):
            fine = spread_full(z, full_grid_windows(points_resc, plan, route),
                               plan, route)
        if spec.spread_only:
            out = fine * plan.kernel_scale
        else:
            with prof.scope("nufft.fft"):
                fine = fft_fine(fine, plan.rank, spec.fft_direction)
            with prof.scope("nufft.deconvolve"):
                out = deconvolve(fine, plan)
    elif spec.spread_only:
        with prof.scope("nufft.interp"):
            out = interp_full(z, full_grid_windows(points_resc, plan, route),
                              plan, route)
        out = out * plan.kernel_scale
    else:
        with prof.scope("nufft.amplify"):
            grid = amplify(z, plan)
        with prof.scope("nufft.fft"):
            grid = fft_fine(grid, plan.rank, spec.fft_direction)
        with prof.scope("nufft.interp"):
            out = interp_full(grid, full_grid_windows(
                points_resc, plan, route), plan, route)
    return torch.view_as_real(out)


def _swapped_type(spec: PlanSpec) -> str:
    return "type_2" if spec.transform_type == "type_1" else "type_1"


def _swapped_direction(spec: PlanSpec) -> str:
    return "backward" if spec.fft_direction == "forward" else "forward"


class _NufftCorePlanar(torch.autograd.Function):
    """The transform, with the JAX package's ``_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, source, points, spec):
        ctx.spec = spec
        ctx.save_for_backward(source, points)
        return _execute_planar(source, points, make_plan(spec))

    @staticmethod
    def backward(ctx, cotangent):
        source, points = ctx.saved_tensors
        spec = ctx.spec
        grad_source = grad_points = None
        if ctx.needs_input_grad[0]:
            # Real transpose == adjoint: swap type AND direction.
            grad_source = nufft_core_planar(
                cotangent, points,
                _replace(spec, transform_type=_swapped_type(spec),
                         fft_direction=_swapped_direction(spec)))
        if ctx.needs_input_grad[1]:
            grad_points = _points_grad(source, points, cotangent, spec)
        return grad_source, grad_points, None


def _points_grad(source, points, cotangent, spec: PlanSpec):
    """Points gradient via mode-weighted type-2 transforms:
      type-2: grad[m, ax] = Re(conj(ct_m) i s t2_s(F k_ax)_m)
                          = s (ct_i aux_r - ct_r aux_i)
      type-1: grad[m, ax] = Re(i s c_m conj(t2_{-s}(ct k_ax)_m))
                          = s (c_r aux_i - c_i aux_r)
    """
    rank, grid_shape = spec.rank, spec.grid_shape
    sign = -1.0 if spec.fft_direction == "forward" else 1.0
    if spec.transform_type == "type_2":
        w_grid, v_pts = source, cotangent       # [B, *grid, 2], [B, M, 2]
        aux_direction = spec.fft_direction
    else:
        w_grid, v_pts = cotangent, source
        aux_direction = _swapped_direction(spec)
    batch = w_grid.shape[0]
    weighted = torch.stack(
        [w_grid * _mode_grid(grid_shape, ax, w_grid.dtype,
                             w_grid.device)[..., None]
         for ax in range(rank)], dim=1)               # [B, rank, *grid, 2]
    aux = nufft_core_planar(
        weighted.reshape((batch * rank,) + grid_shape + (2,)), points,
        _replace(spec, transform_type="type_2", fft_direction=aux_direction,
                 spread_only=False))
    aux = aux.reshape(batch, rank, -1, 2)               # [B, rank, M, 2]
    vr, vi = v_pts[..., 0], v_pts[..., 1]
    aux_r, aux_i = aux[..., 0], aux[..., 1]
    if spec.transform_type == "type_2":
        per = vi[:, None] * aux_r - vr[:, None] * aux_i  # [B, rank, M]
    else:
        per = vr[:, None] * aux_i - vi[:, None] * aux_r
    return sign * per.sum(dim=0).t()                    # [M, rank]


def nufft_core_planar(source: torch.Tensor, points: torch.Tensor,
                      spec: PlanSpec) -> torch.Tensor:
    """Inner-batched planar NUFFT (one point set, B transforms),
    differentiable in ``source`` and ``points``."""
    return _NufftCorePlanar.apply(source, points, spec)


class _SpreadOnlyCorePlanar(torch.autograd.Function):
    """Standalone spread/interp, with the JAX package's
    ``_spread_only_planar_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, source, points, spec):
        ctx.spec = spec
        ctx.save_for_backward(source, points)
        return _execute_planar(source, points, make_plan(spec))

    @staticmethod
    @once_differentiable
    def backward(ctx, cotangent):
        source, points = ctx.saved_tensors
        spec = ctx.spec
        grad_source = grad_points = None
        if ctx.needs_input_grad[0]:
            # Real and phase-free: the plain transpose is the swapped op.
            grad_source = spread_only_core_planar(
                cotangent, points,
                _replace(spec, transform_type=_swapped_type(spec)))
        if ctx.needs_input_grad[1]:
            grad_points = _spread_only_points_grad(source, points,
                                                   cotangent, spec)
        return grad_source, grad_points, None


def _spread_only_points_grad(source, points, cotangent, spec: PlanSpec):
    """Derivative-kernel interp of the grid side, per axis, contracted
    channel-wise with the point side."""
    plan = make_plan(spec)
    if spec.transform_type == "type_2":
        grid_side, pts_side = source, cotangent    # [B, *grid, 2], [B, M, 2]
    else:
        grid_side, pts_side = cotangent, source
    grads = []
    for d, aux in enumerate(_deriv_interps(grid_side, points, plan)):
        factor = -plan.kernel_scale * plan.fine_shape[d] / (2.0 * np.pi)
        grads.append((pts_side * aux).sum(dim=(0, 2)) * factor)
    return torch.stack(grads, dim=-1).to(points.dtype)


def _deriv_interps(grid_side: torch.Tensor, points: torch.Tensor, plan):
    """Per axis d, the planar grid [B, *grid, 2] interpolated at the
    points with phi' on axis d: [B, M, 2] each, on the route of
    ``dispatch.route`` (the XLA-path ops for the native engine, which
    has no phi')."""
    batch = grid_side.shape[0]
    if dispatch.route(plan.spec, grid_side.device) in FULL_GRID_ROUTES:
        points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                             plan.spec.points_range)
        fine = torch.view_as_complex(grid_side.contiguous())
        for d in range(plan.rank):
            indices, kernels = xla_ops.spread_geometry(points_resc, plan,
                                                       deriv_axis=d)
            yield torch.view_as_real(
                xla_ops.interp_xla(fine, indices, kernels, plan))
        return
    geom, binned = bin_for_plan(points, plan)
    tiles = dispatch.extend(grid_side, geom)
    for d in range(plan.rank):
        yield _unfold(dispatch.interp_deriv(tiles, binned, geom, plan, d),
                      batch)


def spread_only_core_planar(source: torch.Tensor, points: torch.Tensor,
                            spec: PlanSpec) -> torch.Tensor:
    """Inner-batched planar spread (type-1) or interp (type-2) with
    ``spec.spread_only``, differentiable in ``source`` and ``points``."""
    return _SpreadOnlyCorePlanar.apply(source, points, spec)
