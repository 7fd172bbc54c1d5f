"""The port's batched planned forms against the JAX package's.

``PlannedNufft.batch_build`` builds one plan per trajectory of an
[S, M, rank] stack with a share of the dense-matrix budget, and
``planar.BatchedPlannedNufft`` gives each shard ``MATS_BYTES_BUDGET //
S``: each shard's level, geometry and slot layout equal a single
``PlannedNufft`` built with that budget, and the JAX package's shard
(``backend='pallas'``, interpret mode); with the budget lowered (both
packages'), a stack whose single plans keep the "mats" level splits down
to "binned", and at rank 3 a shard whose band degenerates re-plans alone.
On CPU tensors (the kernels' plain versions) the batched apply equals the
per-plan loop bit for bit and the JAX package's within 1e-5 of the peak,
both types, with and without the inner batch axis; its gradient is the
adjoint batch's apply and matches ``jax.vjp``; float64 runs the unplanned
route per trajectory, as the JAX ``vmap`` does.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu import planar as jplanar
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu.options import Options
from tensorflow_nufft_tpu_torch import planar as tplanar
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tests.torch_threads import one_torch_thread  # noqa: F401

S, M = 3, 500
PALLAS = Options(backend="pallas")


def relerr(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def stack(grid, transform_type, s=S, m=M, seed=21, dtype=np.float32):
    """Points [S, M, rank] in [-pi, pi) and a planar source."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-np.pi, np.pi, (s, m, len(grid))).astype(dtype)
    shape = (s, m, 2) if transform_type == "type_1" else (s,) + grid + (2,)
    return pts, rng.standard_normal(shape).astype(dtype)


def _geom(g):
    return (g.fine_shape, g.tile, g.pad, g.chunk, g.num_chunks)


def _budget(monkeypatch, budget):
    monkeypatch.setattr(pallas_spread, "MATS_BYTES_BUDGET", budget)
    monkeypatch.setattr(tb, "MATS_BYTES_BUDGET", budget)


def assert_shard_equal(top, jop):
    """A port shard against the JAX package's (or a single port plan)."""
    jlevel = getattr(jop, "level", None) or (
        jop._level if jop._planned else "none")
    assert top.level == jlevel
    if top.level == "none":
        return
    assert _geom(top.geom) == _geom(jop.geom)
    assert top.num_slots == jop.num_slots
    np.testing.assert_array_equal(np.asarray(top.slot_mask),
                                  np.asarray(jop.slot_mask))
    jband = jop.band_info
    if jband is None:
        assert top.band_info is None
    else:
        band = jband.band if hasattr(jband, "band") else jband[0]
        assert top.band_info.band == band


@functools.lru_cache(maxsize=None)
def jax_batched(grid, transform_type):
    """The JAX batched plan and its output on ``stack``'s inputs."""
    pts, src = stack(grid, transform_type)
    jop = jplanar.BatchedPlannedNufft(pts, grid,
                                      transform_type=transform_type,
                                      options=PALLAS)
    return jop, np.asarray(jop(src))


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("grid", [(32, 32), (16, 12, 10)])
def test_shards_match_single_plans_and_jax(grid, transform_type):
    pts, _ = stack(grid, transform_type)
    jop, _ = jax_batched(grid, transform_type)
    op = tplanar.BatchedPlannedNufft(pts, grid,
                                     transform_type=transform_type,
                                     device="cpu")
    assert op.num_batches == S and op.num_points == M and op._planned
    assert op.grid_shape == grid and op.transform_type == transform_type
    for i, shard in enumerate(op._shards):
        single = tplanar.PlannedNufft(
            pts[i], grid, transform_type=transform_type, device="cpu",
            payload_budget_bytes=tb.MATS_BYTES_BUDGET // S)
        assert_shard_equal(shard, single)
        assert_shard_equal(shard, jop._shards[i])


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("grid", [(32, 32), (16, 12, 10)])
def test_outputs_equal_loop_and_match_jax(grid, transform_type):
    pts, src = stack(grid, transform_type)
    _, want = jax_batched(grid, transform_type)
    op = tplanar.BatchedPlannedNufft(pts, grid,
                                     transform_type=transform_type,
                                     device="cpu")
    src_t = torch.from_numpy(src)
    got = op(src_t)
    for i, shard in enumerate(op._shards):
        assert torch.equal(got[i], shard(src_t[i][None])[0])
    assert relerr(got, want) <= 1e-5
    # The inner batch axis: [S, 2, ...] is two applies.
    inner = op(torch.stack([src_t, 2 * src_t], dim=1))
    assert torch.equal(inner[:, 0], got)
    assert torch.equal(inner[:, 1], op(2 * src_t))


def test_inner_axis_matches_jax():
    grid = (32, 32)
    pts, src = stack(grid, "type_2")
    jop, _ = jax_batched(grid, "type_2")
    src2 = np.stack([src, -src], axis=1)
    op = tplanar.BatchedPlannedNufft(pts, grid, device="cpu")
    assert relerr(op(torch.from_numpy(src2)), jop(src2)) <= 1e-5


def test_budget_split_to_binned(monkeypatch):
    """A budget that lets one plan keep its dense matrices but not a
    third of it: single plans "mats", the stack's shards "binned"."""
    grid = (32, 32)
    pts, src = stack(grid, "type_2")
    need = tb.mats_payload_bytes(
        tplanar.PlannedNufft(pts[0], grid, device="cpu").geom)
    _budget(monkeypatch, 2 * need)
    assert tplanar.PlannedNufft(pts[0], grid, device="cpu").level == "mats"
    jop = jplanar.BatchedPlannedNufft(pts, grid, options=PALLAS)
    op = tplanar.BatchedPlannedNufft(pts, grid, device="cpu")
    for i, shard in enumerate(op._shards):
        assert shard.level == "binned"
        assert_shard_equal(shard, jop._shards[i])
        assert_shard_equal(shard, tplanar.PlannedNufft(
            pts[i], grid, payload_budget_bytes=2 * need // S,
            device="cpu"))
    src_t = torch.from_numpy(src)
    got = op(src_t)
    for i, shard in enumerate(op._shards):
        assert torch.equal(got[i], shard(src_t[i][None])[0])


def test_rank3_shard_replans_alone(monkeypatch):
    """Binned level, the memory model lowered as in
    ``tests/test_torch_replan.py``: the uniform shard keeps its band, the
    clustered one re-plans on the unbanded geometry, as the JAX shards
    do."""
    grid, m = (32, 16, 16), 3000
    _budget(monkeypatch, 0)
    monkeypatch.setattr(pallas_spread, "VMEM_RESIDENT_BUDGET", 3_800_000)
    monkeypatch.setattr(tb, "VMEM_RESIDENT_BUDGET", 3_800_000)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-np.pi, np.pi, (2, m, 3))
    pts[1, :, 0] = (np.where(rng.random(m) < 0.5, 0.0, 2.0)
                    + 0.3 * rng.standard_normal(m))
    pts = pts.astype(np.float32)
    jop = jplanar.BatchedPlannedNufft(pts, grid, transform_type="type_1",
                                      options=PALLAS)
    op = tplanar.BatchedPlannedNufft(pts, grid, transform_type="type_1",
                                     device="cpu")
    s0, s1 = op._shards
    assert s0.level == s1.level == "binned"
    plan = s0.plan
    banded = tb.choose_geometry(plan.fine_shape, plan.width, m, banded=True)
    assert s0.geom == banded and s0.band_info is not None
    assert s1.geom == tb.choose_geometry(plan.fine_shape, plan.width, m)
    for shard, jshard in zip(op._shards, jop._shards):
        assert_shard_equal(shard, jshard)
    src = torch.from_numpy(rng.standard_normal((2, m, 2)).astype(
        np.float32))
    got = op(src)
    for i, shard in enumerate(op._shards):
        assert torch.equal(got[i], shard(src[i][None])[0])


def test_gradient_is_adjoint_batch_and_matches_jax():
    grid = (32, 32)
    pts, src = stack(grid, "type_2")
    ct = np.random.default_rng(5).standard_normal((S, M, 2)).astype(
        np.float32)
    jop, _ = jax_batched(grid, "type_2")
    _, vjp = jax.vjp(jop, src)
    want, = vjp(ct)
    op = tplanar.BatchedPlannedNufft(pts, grid, device="cpu")
    x = torch.from_numpy(src).requires_grad_()
    op(x).backward(torch.from_numpy(ct))
    adj = op.adjoint()
    assert adj.transform_type == "type_1"
    assert adj.fft_direction == "backward" and adj.adjoint() is op
    for shard, ashard in zip(op._shards, adj._shards):
        assert ashard.binned is shard.binned
    assert torch.equal(x.grad, adj(torch.from_numpy(ct)))
    assert relerr(x.grad, want) <= 1e-5


def test_unplanned_route_matches_jax():
    """Float64 (and backend='xla') shards are at level "none": each
    trajectory runs planar.nufft."""
    grid = (24, 20)
    pts, src = stack(grid, "type_1", s=2, m=300, dtype=np.float64)
    jop = jplanar.BatchedPlannedNufft(pts, grid, transform_type="type_1")
    want = np.asarray(jop(src))
    op = tplanar.BatchedPlannedNufft(pts, grid, transform_type="type_1",
                                     device="cpu")
    assert not op._planned
    got = op(torch.from_numpy(src))
    assert relerr(got, want) <= 1e-10
    x = torch.from_numpy(src).requires_grad_()
    op(x).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    xla = tplanar.BatchedPlannedNufft(
        pts.astype(np.float32), grid, transform_type="type_1",
        options=tplanar.Options(backend="xla"), device="cpu")
    assert not xla._planned
    assert relerr(xla(torch.from_numpy(src.astype(np.float32))),
                  want) <= 1e-5


def test_from_batch_alias():
    grid = (32, 32)
    pts, src = stack(grid, "type_1")
    op = tplanar.PlannedNufft.from_batch(pts, grid, transform_type="type_1",
                                         device="cpu")
    assert isinstance(op, tplanar.BatchedPlannedNufft)
    ref = tplanar.BatchedPlannedNufft(pts, grid, transform_type="type_1",
                                      device="cpu")
    assert torch.equal(op(torch.from_numpy(src)), ref(torch.from_numpy(src)))
    shards = tplanar.PlannedNufft.batch_build(
        torch.from_numpy(pts), grid, transform_type="type_1",
        payload_budget_bytes=tb.MATS_BYTES_BUDGET // S)
    assert len(shards) == S
    for shard, want in zip(shards, ref._shards):
        assert_shard_equal(shard, want)


@pytest.mark.parametrize("transform_type,shape", [
    ("type_2", (S, 31, 32, 2)),
    ("type_2", (S + 1, 32, 32, 2)),
    ("type_2", (S, 1, 1, 32, 32, 2)),
    ("type_1", (S, M + 1, 2)),
    ("type_1", (S, M, 3)),
])
def test_shape_messages_are_jax(transform_type, shape):
    grid = (32, 32)
    pts, _ = stack(grid, transform_type)
    jop = jplanar.BatchedPlannedNufft(pts, grid,
                                      transform_type=transform_type)
    op = tplanar.BatchedPlannedNufft(pts, grid,
                                     transform_type=transform_type,
                                     device="cpu")
    bad = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        jop(bad)
    with pytest.raises(ValueError) as got:
        op(torch.from_numpy(bad))
    assert str(got.value) == str(want.value)


def test_points_messages():
    with pytest.raises(ValueError) as want:
        jplanar.BatchedPlannedNufft(np.zeros((5, 2), np.float32), (8, 8))
    with pytest.raises(ValueError) as got:
        tplanar.BatchedPlannedNufft(torch.zeros(5, 2), (8, 8))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="plan data"):
        tplanar.BatchedPlannedNufft(torch.zeros(2, 5, 2).requires_grad_(),
                                    (8, 8))
