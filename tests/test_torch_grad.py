"""Gradients of the port's planar NUFFT against the JAX package.

``tnt.planar.nufft`` and ``tnt.PlannedNufft`` on CPU tensors (the plain
versions of the kernels), backpropagated with a seeded cotangent, against
``jax.vjp`` of ``tfft.planar.nufft`` / ``PlannedNufft`` on the same numpy
inputs: to 1e-5 of the peak against ``backend="pallas"`` (the Pallas
kernels in interpret mode), and to 1e-3 (the JAX tests' gate) against
``jax.vjp`` of the dense ``tfft.planar.nudft`` in float64.

Rank 3 has one small case, against ``backend="xla"``: in interpret
mode the 3D Pallas chain costs seconds per call, and the port's rank-3
kernels are held to those Pallas kernels in ``test_torch_kernels3d.py``
and ``test_torch_stages3d.py``.

At rank 2 the batch is 3, so the spread of the source gradient (type-2)
or of the forward (type-1) has B2 = 6 channels and 2 * rank + B2 > 8:
the TPU runs its split-payload spreads there, ``_spread_kernel_resident_
split`` and, where the tile array does not stay resident,
``_spread_kernel_split`` (held at the kernel level below). A spy records
which ran; the port's one unplanned spread replaces both. Both rank-2
cases share their grid and points, so that JAX compiles their common
kernels once. Each JAX reference is computed once per
module (interpret-mode Pallas compiles dominate the time) and shared.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning, spread
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
ORACLE_TOL = 1e-3
PALLAS = tfft.Options(backend="pallas")
# name: (grid, points, batch, type, direction, JAX split kernel to reach)
CASES = {
    "2d_type_2_forward": ((32, 48), 400, 3, "type_2", "forward",
                          "_spread_kernel_resident_split"),
    "2d_type_1_backward": ((32, 48), 400, 3, "type_1", "backward",
                           "_spread_kernel_resident_split"),
    "3d_type_2_backward": ((8, 8, 16), 300, 1, "type_2", "backward", None),
}
XLA = tfft.Options(backend="xla")


def _relerr(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(grid, m, batch, transform_type, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(np.float32)
    shape = (batch,) + ((m,) if transform_type == "type_1" else grid) + (2,)
    out_shape = (batch,) + (grid if transform_type == "type_1" else (m,)) \
        + (2,)
    return (pts, rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(out_shape).astype(np.float32))


def _kwargs(grid, transform_type, direction):
    return dict(grid_shape=grid if transform_type == "type_1" else None,
                transform_type=transform_type, fft_direction=direction)


def _spy(module, name, calls):
    kernel = getattr(module, name)

    def traced(*args, **kwargs):
        calls.append(name)
        return kernel(*args, **kwargs)
    return mock.patch.object(module, name, traced)


@functools.lru_cache(maxsize=None)
def case(name):
    """Inputs of one case, the JAX vjp on them (Pallas at rank 2, with
    the split spread kernels it ran) and the float64 nudft vjp."""
    grid, m, batch, transform_type, direction, _ = CASES[name]
    pts, src, ct = _inputs(grid, m, batch, transform_type, len(grid))
    kw = _kwargs(grid, transform_type, direction)
    calls = []
    with _spy(pallas_spread, "_spread_kernel_resident_split", calls):
        options = PALLAS if len(grid) == 2 else XLA
        out, vjp = jax.vjp(
            lambda s, p: tfft.planar.nufft(s, p, options=options, **kw),
            src, pts)
        grads = [np.asarray(g) for g in vjp(ct)]
    _, vjp64 = jax.vjp(lambda s, p: tfft.planar.nudft(s, p, **kw),
                       src.astype(np.float64), pts.astype(np.float64))
    oracle = [np.asarray(g) for g in vjp64(ct.astype(np.float64))]
    return dict(pts=pts, src=src, ct=ct, kw=kw, out=np.asarray(out),
                grads=grads, oracle=oracle, calls=set(calls))


def _port_grads(src, pts, ct, **kw):
    s = torch.from_numpy(src).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    out = tnt.planar.nufft(s, p, **kw)
    out.backward(torch.from_numpy(ct))
    return out, s.grad, p.grad


@pytest.mark.parametrize("name", list(CASES))
def test_nufft_grads_match_jax_and_oracle(name):
    c = case(name)
    kernel = CASES[name][-1]
    if kernel is not None:
        assert kernel in c["calls"], f"the JAX run did not reach {kernel}"
    out, g_src, g_pts = _port_grads(c["src"], c["pts"], c["ct"], **c["kw"])
    assert _relerr(out, c["out"]) <= RTOL
    for got, want, oracle in zip((g_src, g_pts), c["grads"], c["oracle"]):
        assert got.dtype == torch.float32
        assert _relerr(got, want) <= RTOL
        assert _relerr(got, oracle) <= ORACLE_TOL


@functools.lru_cache(maxsize=None)
def planned_case():
    """The JAX PlannedNufft type-2 vjp at its Pallas mats level."""
    grid = (32, 48)
    pts, src, ct = _inputs(grid, 300, 2, "type_2", 42)
    jop = tfft.planar.PlannedNufft(pts, grid, transform_type="type_2",
                                   options=PALLAS)
    _, vjp = jax.vjp(jop, src)
    return dict(pts=pts, src=src, ct=ct, grid=grid, direction="forward",
                want=np.asarray(vjp(ct)[0]))


@pytest.mark.parametrize("rank", (2, 3))
def test_planned_source_grad_is_the_adjoint_and_matches_jax(rank):
    """At rank 3 the JAX reference is the unplanned vjp of the 3D case:
    the JAX XLA path's planned call is the unplanned transform."""
    if rank == 2:
        c = planned_case()
        grid, direction, want = c["grid"], c["direction"], c["want"]
    else:
        c = case("3d_type_2_backward")
        grid, direction, want = c["src"].shape[1:-1], "backward", \
            c["grads"][0]
    op = tnt.PlannedNufft(c["pts"], grid, transform_type="type_2",
                          fft_direction=direction, device="cpu")
    s = torch.from_numpy(c["src"]).requires_grad_()
    op(s).backward(torch.from_numpy(c["ct"]))
    assert torch.equal(s.grad, op.adjoint()(torch.from_numpy(c["ct"])))
    assert _relerr(s.grad, want) <= RTOL


def test_broadcast_and_chunked_grads():
    """Source batch (3, 1) x points batch (2,) -> (3, 2), the JAX tests'
    broadcasting case: the gradients reduce over the broadcast dims, to
    the sums of the per-slice gradients (float32 summation order) and to
    the float64 nudft vjp at the oracle gate; ``max_batch_size`` chunks
    of the inner batch give the same gradients."""
    grid, m = (16, 16), 60
    rng = np.random.default_rng(50)
    src = rng.standard_normal((3, 1) + grid + (2,)).astype(np.float32)
    pts = rng.uniform(-np.pi, np.pi, (2, m, 2)).astype(np.float32)
    ct = rng.standard_normal((3, 2, m, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda s, p: tfft.planar.nudft(s, p),
                     src.astype(np.float64), pts.astype(np.float64))
    oracle = [np.asarray(g) for g in vjp(ct.astype(np.float64))]
    slices = [_port_grads(src[:, 0], pts[j], ct[:, j]) for j in range(2)]
    sliced = (sum(g[1] for g in slices)[:, None],
              torch.stack([g[2] for g in slices]))
    for options in (None, tnt.Options(max_batch_size=2)):
        _, g_src, g_pts = _port_grads(src, pts, ct, options=options)
        assert g_src.shape == src.shape and g_pts.shape == pts.shape
        for got, ref, want in zip((g_src, g_pts), sliced, oracle):
            assert _relerr(got, ref) <= 1e-6
            assert _relerr(got, want) <= ORACLE_TOL


@pytest.mark.parametrize("rank,b2,per_tile_grid", [
    (2, 16, False), (2, 6, True), (3, 6, True)])
def test_wide_spread_is_the_split_kernel(rank, b2, per_tile_grid):
    """The plain unplanned spread at 2 * rank + B2 > 8 channels against
    the TPU's split-payload spreads on the identical layout, at 16
    channels (two of the port's channel groups at the 2D headline) and
    at rank 3, where the tile array never stays resident."""
    grid = (32, 48) if rank == 2 else (8, 8, 16)
    pts, _, _ = _inputs(grid, 500, 1, "type_1", 60 + b2)
    vals = np.random.default_rng(b2).standard_normal((b2, 500)).astype(
        np.float32)
    plan = make_plan(PlanSpec("type_1", "forward", rank, grid, "complex64",
                              1e-6, 1))
    geom, binned = bin_for_plan(torch.from_numpy(pts), plan)
    jax_plan = jplan.make_plan(jplan.PlanSpec(
        "type_1", "forward", rank, grid, "complex64", 1e-6, 1))
    pr = tuple(jax.numpy.asarray(x.numpy())
               for x in (binned.points_hi, binned.points_lo))
    kernel = "_spread_kernel_split" if per_tile_grid \
        else "_spread_kernel_resident_split"
    calls = []
    with _spy(pallas_spread, kernel, calls), mock.patch.object(
            pallas_spread, "resident_fits",
            (lambda *_: False) if per_tile_grid
            else pallas_spread.resident_fits):
        want, _ = pallas_spread.spread_pallas_tiles(
            jax.numpy.asarray(vals), pr, jax_plan)
    assert calls, f"{kernel} did not run"
    values_pl = binning.build_values_payload(torch.from_numpy(vals), binned)
    got = spread.spread_tiles_plain(values_pl, binned.tile_bounds, geom, plan,
                                    coords=binning.build_coords_payload(binned))
    assert _relerr(got, want) <= RTOL


@pytest.mark.parametrize("rank,transform_type", [
    (2, "type_1"), (2, "type_2"), (3, "type_1"), (3, "type_2")])
def test_gradcheck_float64(rank, transform_type):
    """Central differences (fast mode: one random direction per input)
    against the analytic gradients at tol 1e-12. atol 1e-6: outputs of
    magnitude ~10 carry float64 rounding of ~1e-15 relative, which a
    difference step of 1e-6 amplifies to ~1e-8."""
    grid = (16, 16) if rank == 2 else (8, 8, 12)
    pts, src, _ = _inputs(grid, 10, 2, transform_type, 70 + rank)
    s = torch.from_numpy(src.astype(np.float64)).requires_grad_()
    p = torch.from_numpy(pts.astype(np.float64)).requires_grad_()
    kw = _kwargs(grid, transform_type, "backward")
    assert torch.autograd.gradcheck(
        lambda s, p: tnt.planar.nufft(s, p, tol=1e-12, **kw), (s, p),
        atol=1e-6, rtol=1e-5, fast_mode=True)


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_gradgradcheck_float64(transform_type):
    """The backward is built from the differentiable transforms, so the
    second derivative exists (as JAX's does)."""
    grid = (16, 16)
    pts, src, _ = _inputs(grid, 10, 2, transform_type, 80)
    s = torch.from_numpy(src.astype(np.float64)).requires_grad_()
    p = torch.from_numpy(pts.astype(np.float64)).requires_grad_()
    kw = _kwargs(grid, transform_type, "forward")
    assert torch.autograd.gradgradcheck(
        lambda s, p: tnt.planar.nufft(s, p, tol=1e-12, **kw), (s, p),
        atol=1e-6, rtol=1e-5, fast_mode=True)


def test_plan_points_are_plan_data():
    pts = torch.from_numpy(_inputs((16, 16), 50, 1, "type_2", 90)[0])
    with pytest.raises(ValueError, match="plan data"):
        tnt.PlannedNufft(pts.clone().requires_grad_(), (16, 16))
    op = tnt.PlannedNufft(pts, (16, 16), device="cpu")
    src = torch.zeros((1, 16, 16, 2), requires_grad=True)
    out = op(src)
    assert out.requires_grad and not op.points.requires_grad
