"""The port's standalone ``planar.interp``/``planar.spread`` and their
derivative-kernel interp against the JAX package.

- ``dispatch.interp_deriv`` (CPU tensors: the plain interp with phi' on
  one axis) against the JAX ``dispatch.interp_deriv`` under a
  ``backend="pallas"`` plan, which runs ``pallas_interp._interp_kernel``
  with its ``deriv_axis`` flag in interpret mode (a spy records the
  flag), for each axis at ranks 2 and 3, to 1e-5 of the peak.
- ``tnt.planar.interp``/``spread`` forward and ``source``/``points``
  gradients against ``jax.vjp`` of ``tfft.planar.interp``/``spread`` (its
  analytic custom VJP on the XLA path) to 1e-5 of the peak, and
  ``gradcheck`` in float64.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.kernels import dispatch as jdispatch
from tensorflow_nufft_tpu.kernels import pallas_interp, xla_ops
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import dispatch, interp
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
GRIDS = {2: (32, 48), 3: (32, 32, 64)}
M = 500


def _relerr(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _points(rank, seed, m=M):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (m, rank)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def deriv_case(rank, axis):
    """A planar grid, points, and the JAX Pallas derivative interp of
    them with the deriv_axis values the Pallas kernel was traced with."""
    grid = GRIDS[rank]
    pts = _points(rank, rank)
    grid_p = np.random.default_rng(10 + rank).standard_normal(
        (1,) + grid + (2,)).astype(np.float32)
    plan = jplan.make_plan(jplan.PlanSpec(
        "type_2", "forward", rank, grid, "complex64", 1e-6, 1,
        spread_only=True, backend="pallas"))
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), plan.fine_shape, 1)
    flags = []
    kernel = pallas_interp._interp_kernel

    def traced(*args, **kwargs):
        flags.append(kwargs.get("deriv_axis"))
        return kernel(*args, **kwargs)
    with mock.patch.object(pallas_interp, "_interp_kernel", traced):
        want = jdispatch.interp_deriv(
            jnp.asarray(np.moveaxis(grid_p, -1, 1).reshape((2,) + grid)),
            pr, plan, axis)
    return pts, grid_p, np.asarray(want), flags


@pytest.mark.parametrize("rank,axis", [(2, 0), (2, 1), (3, 0), (3, 1),
                                       (3, 2)])
def test_deriv_interp_matches_the_pallas_deriv_kernel(rank, axis):
    pts, grid_p, want, flags = deriv_case(rank, axis)
    assert flags and set(flags) == {axis}, flags
    plan = tplan.make_plan(tplan.PlanSpec(
        "type_2", "forward", rank, GRIDS[rank], "complex64", 1e-6, 1,
        spread_only=True))
    geom, binned = bin_for_plan(torch.from_numpy(pts), plan)
    before = interp.interp_deriv_cuda.launches
    tiles = dispatch.extend(torch.from_numpy(grid_p), geom)
    got = dispatch.interp_deriv(tiles, binned, geom, plan, axis)  # [2, M]
    assert interp.interp_deriv_cuda.launches == before
    assert _relerr(got, want) <= RTOL


@functools.lru_cache(maxsize=None)
def op_case(rank, transform_type):
    """Inputs of a spread-only op and ``jax.vjp`` of the JAX op on them
    (default backend: XLA on the CPU)."""
    grid = GRIDS[rank]
    rng = np.random.default_rng(20 + rank)
    pts = _points(rank, 30 + rank)
    shape = (2, M, 2) if transform_type == "type_1" else (2,) + grid + (2,)
    src = rng.standard_normal(shape).astype(np.float32)
    if transform_type == "type_1":
        fn = functools.partial(tfft.planar.spread, grid_shape=grid)
    else:
        fn = tfft.planar.interp
    out, vjp = jax.vjp(fn, src, pts)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    return pts, src, ct, np.asarray(out), [np.asarray(g) for g in vjp(ct)]


def _port_op(transform_type, rank):
    if transform_type == "type_1":
        return functools.partial(tnt.planar.spread, grid_shape=GRIDS[rank])
    return tnt.planar.interp


@pytest.mark.parametrize("rank,transform_type", [
    (2, "type_1"), (2, "type_2"), (3, "type_2")])
def test_spread_only_ops_and_grads_match_jax(rank, transform_type):
    pts, src, ct, want, grads = op_case(rank, transform_type)
    s = torch.from_numpy(src).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    out = _port_op(transform_type, rank)(s, p)
    assert _relerr(out, want) <= RTOL
    out.backward(torch.from_numpy(ct))
    assert _relerr(s.grad, grads[0]) <= RTOL
    assert _relerr(p.grad, grads[1]) <= RTOL


@pytest.mark.parametrize("rank,transform_type", [
    (2, "type_1"), (2, "type_2"), (3, "type_1"), (3, "type_2")])
def test_spread_only_gradcheck_float64(rank, transform_type):
    """Fast-mode gradcheck at tol 1e-12 (width 14: grids of 30-32); atol
    as in ``test_torch_grad.py``."""
    grid = (32, 32) if rank == 2 else (30, 30, 30)
    rng = np.random.default_rng(40 + rank)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (10, rank)))
    shape = (2, 10, 2) if transform_type == "type_1" else (2,) + grid + (2,)
    src = torch.from_numpy(rng.standard_normal(shape))
    if transform_type == "type_1":
        fn = functools.partial(tnt.planar.spread, grid_shape=grid, tol=1e-12)
    else:
        fn = functools.partial(tnt.planar.interp, tol=1e-12)
    assert torch.autograd.gradcheck(
        fn, (src.requires_grad_(), pts.requires_grad_()), atol=1e-6,
        rtol=1e-5, fast_mode=True)


def test_spread_only_has_no_second_derivative():
    """The derivative-kernel interp has no gradient of its own (as the
    JAX package's Pallas path), so a double backward raises."""
    pts = torch.from_numpy(_points(2, 50, 20)).requires_grad_()
    src = torch.ones((1, 20, 2), requires_grad=True)
    out = tnt.planar.spread(src, pts, (32, 32))
    g, = torch.autograd.grad(out.square().sum(), pts, create_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        g.sum().backward()
