"""The port's 3D planar NUFFT end to end against the JAX package, and the
entry points' device rule.

``tnt.planar.nufft`` and ``tnt.PlannedNufft`` (+ ``adjoint()``) at rank 3
on CPU tensors (the plain versions of the kernels) against
``tfft.planar.nufft`` on the same numpy-seeded inputs, to 1e-5 of the
peak (the JAX ``PlannedNufft``'s own 3D planned level is held in
``test_torch_banded3d.py``); and against the port's dense ``nudft`` at
the JAX tests' gate, 1e-3. Geometry: modes (16, 16, 64), fine (32, 32,
128), 2 x 2 x 2 tiles, so every halo wraps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (16, 16, 64)
M = 3000
RTOL = 1e-5
ORACLE_TOL = 1e-3


def _points(m, seed, dtype=np.float32):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (m, 3)).astype(dtype)


def _source(transform_type, m, batch, seed, dtype=np.float32):
    shape = batch + ((m,) if transform_type == "type_1" else GRID) + (2,)
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@functools.lru_cache(maxsize=None)
def case(transform_type, direction, dtype):
    """Seeded points and source of one transform, and the JAX package's
    result on them (one XLA compile per case, shared by the tests)."""
    pts = _points(M, 1, dtype)
    src = _source(transform_type, M, (), 2, dtype)
    want = np.asarray(jax.jit(functools.partial(
        tfft.planar.nufft,
        grid_shape=GRID if transform_type == "type_1" else None,
        transform_type=transform_type, fft_direction=direction))(src, pts))
    return pts, src, want


@pytest.mark.parametrize("transform_type,direction,dtype", [
    ("type_1", "forward", np.float32), ("type_1", "backward", np.float64),
    ("type_2", "forward", np.float64), ("type_2", "backward", np.float32)])
def test_nufft_matches_jax_3d(transform_type, direction, dtype):
    pts, src, want = case(transform_type, direction, dtype)
    got = tnt.planar.nufft(
        torch.from_numpy(src), torch.from_numpy(pts),
        grid_shape=GRID if transform_type == "type_1" else None,
        transform_type=transform_type, fft_direction=direction)
    assert got.dtype == torch.from_numpy(src).dtype
    assert got.device.type == "cpu"
    assert _relerr(got, want) <= RTOL


@pytest.mark.parametrize("transform_type,dtype", [
    ("type_1", np.float32), ("type_2", np.float64)])
def test_planned_and_adjoint_match_jax_3d(transform_type, dtype):
    """A batch of two (x, 2x: scaling by 2 is exact) through the plan and
    its adjoint, against the JAX package on x."""
    adj_type = "type_2" if transform_type == "type_1" else "type_1"
    pts, src, want = case(transform_type, "forward", dtype)
    _, adj_src, adj_want = case(adj_type, "backward", dtype)
    top = tnt.PlannedNufft(pts, GRID, transform_type=transform_type,
                           device="cpu")
    assert top.device.type == "cpu"
    # Float64 points take the JAX package's plan level "none" (its Pallas
    # path, like the port's kernels, is float32 only): planar.nufft.
    assert top.level == ("mats" if dtype == np.float32 else "none")
    if top.level == "mats":
        assert top.weights.weights.shape[0] == 3
    pair = torch.from_numpy(np.stack([src, 2 * src]))
    assert _relerr(top(pair), np.stack([want, 2 * want])) <= RTOL
    adj = top.adjoint()
    assert adj.fft_direction == "backward" and adj.adjoint() is top
    adj_pair = torch.from_numpy(np.stack([adj_src, 2 * adj_src]))
    assert _relerr(adj(adj_pair), np.stack([adj_want, 2 * adj_want])) \
        <= RTOL
    unplanned = tnt.planar.nufft(
        pair, torch.from_numpy(pts),
        grid_shape=GRID if transform_type == "type_1" else None,
        transform_type=transform_type)
    assert torch.equal(top(pair), unplanned)


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_nufft_matches_nudft_3d(transform_type):
    m = 400
    pts = _points(m, 6)
    src = _source(transform_type, m, (), 7)
    kw = dict(grid_shape=GRID if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           **kw)
    oracle = tnt.planar.nudft(src.astype(np.float64),
                              pts.astype(np.float64), device="cpu", **kw)
    assert oracle.dtype == torch.float64
    assert _relerr(got, oracle) <= ORACLE_TOL


def test_planned_adjoint_identity_3d():
    """<A x, y> == <x, A^H y> for the planned pair."""
    pts = _points(1500, 8)
    op = tnt.PlannedNufft(pts, GRID, transform_type="type_2", device="cpu")
    x = torch.from_numpy(_source("type_2", 1500, (1,), 9)).double()
    y = torch.from_numpy(_source("type_1", 1500, (1,), 10)).double()
    ax = tnt.planar.from_planar(op(x.float()).double())
    ahy = tnt.planar.from_planar(op.adjoint()(y.float()).double())
    lhs = torch.vdot(ax.flatten(), tnt.planar.from_planar(y).flatten())
    rhs = torch.vdot(tnt.planar.from_planar(x).flatten(), ahy.flatten())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_numpy_input_lands_on_the_card_unless_told():
    """Numpy input runs on the CUDA card by default; ``device="cpu"``
    runs it on the CPU; tensors keep their device."""
    pts = _points(200, 11)
    src = _source("type_1", 200, (), 12)
    kw = dict(grid_shape=GRID, transform_type="type_1")
    out = tnt.planar.nufft(src, pts, device="cpu", **kw)
    assert out.device.type == "cpu"
    assert tnt.PlannedNufft(pts, GRID, device="cpu").device.type == "cpu"
    out = tnt.planar.nufft(torch.from_numpy(src), pts, **kw)
    assert out.device.type == "cpu"          # follows the tensor beside it
    assert tnt.planar.nudft(src, pts, device="cpu", **kw).device.type \
        == "cpu"
    calls = (lambda: tnt.planar.nufft(src, pts, **kw),
             lambda: tnt.planar.nudft(src, pts, **kw),
             lambda: tnt.PlannedNufft(pts, GRID).device)
    if torch.cuda.is_available():
        for call in calls:
            got = call()
            assert (got if isinstance(got, torch.device)
                    else got.device).type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA device"):
                call()


def test_fine_grid_guards_match_jax_3d():
    """The allocation guard and the automatic batch cap agree with the
    JAX package's at rank 3, at the 3D headline and near the limit."""
    for grid in ((128, 128, 128), GRID, (512, 512, 400)):
        kw = dict(transform_type="type_1", fft_direction="forward", rank=3,
                  grid_shape=grid, dtype_name="complex64", tol=1e-6,
                  points_range=1)
        js, ts = jplan.PlanSpec(**kw), tplan.PlanSpec(**kw)
        jp, tp = jplan.make_plan(js), tplan.make_plan(ts)
        assert tp.fine_shape == jp.fine_shape
        cap = tplan.auto_max_batch_size(ts, channels_per_batch=2)
        assert cap == jplan.auto_max_batch_size(js, channels_per_batch=2)
        for batch in (1, 2, 2 * cap, 2 * cap + 2):
            outcomes = []
            for check in (jplan.check_fine_grid_size,
                          tplan.check_fine_grid_size):
                try:
                    check(jp if check is jplan.check_fine_grid_size
                          else tp, batch)
                    outcomes.append("ok")
                except ValueError:
                    outcomes.append("raised")
            assert outcomes[0] == outcomes[1], (grid, batch)
    assert tplan.make_plan(tplan.PlanSpec(
        "type_1", "forward", 3, (128, 128, 128), "complex64", 1e-6,
        1)).fine_shape == (256, 256, 256)


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_nufft_matches_jax_with_a_long_fine_axis(transform_type):
    """Modes (8, 8, 4096): the fine grid (16, 16, 8192) has an axis
    longer than one block's shared memory, which the card's FFT kernel
    takes in two launches; on the CPU the port's plain stages against the
    JAX package at 64 points."""
    grid = (8, 8, 4096)
    pts = _points(64, 13)
    rng = np.random.default_rng(14)
    src = rng.standard_normal(
        (64, 2) if transform_type == "type_1" else grid + (2,)).astype(
            np.float32)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = np.asarray(jax.jit(functools.partial(tfft.planar.nufft, **kw))(
        src, pts))
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           **kw)
    assert _relerr(got, want) <= RTOL
