"""The port's sharding (``tnt.parallel``) against the JAX package.

The port's sharded transforms run one process over a ``parallel.Mesh``
of logical CPU devices ((2, 4) ("data", "points"), (4,) "grid") on the
global inputs of ``tests/test_parallel.py``'s size (16^2 grid, 64
points, batch 4). ``tests/test_parallel.py`` holds each JAX sharded
function to the JAX unsharded transform; here each port function is held
to that JAX unsharded transform (``planar.nufft``, ``PlannedNufft``,
``planar.Type3Plan``) on the same inputs, within 1e-5 of the peak, so no
JAX ``shard_map`` runs. The JAX ``ShardedPlannedNufft`` is only built
(on the 8-device mesh of ``tests/conftest.py``, ``backend='pallas'``),
never applied: its per-shard integer artifacts, band, slot count and
slot mask equal the port's bit for bit at the 2D "mats" level and at a
rank-3 banded "binned" level. Gradients, meshes (one mixing devices),
messages, chunking, the unplanned fallback, the slot surface and the
band rule where one shard re-plans are held to the port's own unsharded
transforms.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu.parallel import (
    ShardedPlannedNufft as JaxShardedPlannedNufft)
from tensorflow_nufft_tpu_torch import Options, planar
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.parallel import (
    Mesh, ShardedPlannedNufft, sharded_nufft, sharded_nufft_grid,
    sharded_nufft_type3)
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID, B, M = (16, 16), 4, 64
RTOL = 1e-5


def relerr(got, want):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def cpu_mesh(shape=(2, 4), names=("data", "points")):
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                names)


@functools.lru_cache(maxsize=None)
def problem():
    """Points [M, 2], type-2 images [B, *GRID, 2], type-1 strengths
    [B, M, 2] (float32 numpy)."""
    rng = np.random.default_rng(42)
    points = rng.uniform(-np.pi, np.pi, (M, 2)).astype(np.float32)
    images = rng.standard_normal((B,) + GRID + (2,)).astype(np.float32)
    strengths = rng.standard_normal((B, M, 2)).astype(np.float32)
    return points, images, strengths


def tensors():
    return tuple(torch.from_numpy(x) for x in problem())


@functools.lru_cache(maxsize=None)
def jax_nufft(transform_type, fft_direction="forward"):
    """The JAX unsharded planar transform on ``problem``'s inputs."""
    points, images, strengths = problem()
    if transform_type == "type_1":
        return np.asarray(jax.jit(lambda s, p: tfft.planar.nufft(
            s, p, grid_shape=GRID, transform_type="type_1",
            fft_direction=fft_direction))(strengths, points))
    return np.asarray(jax.jit(lambda s, p: tfft.planar.nufft(
        s, p, fft_direction=fft_direction))(images, points))


# -- each public function against the JAX unsharded transform ------------


@pytest.mark.parametrize("transform_type", ["type_2", "type_1"])
def test_sharded_nufft_matches_jax(transform_type):
    points, images, strengths = tensors()
    if transform_type == "type_1":
        got = sharded_nufft(strengths, points, cpu_mesh(), grid_shape=GRID,
                            transform_type="type_1")
    else:
        got = sharded_nufft(images, points, cpu_mesh())
    assert relerr(got, jax_nufft(transform_type)) <= RTOL


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_sharded_nufft_grid_matches_jax(transform_type):
    points, images, strengths = tensors()
    mesh = cpu_mesh((4,), ("grid",))
    if transform_type == "type_1":
        got = sharded_nufft_grid(strengths, points, mesh, grid_shape=GRID,
                                 transform_type="type_1")
    else:
        got = sharded_nufft_grid(images, points, mesh)
    assert relerr(got, jax_nufft(transform_type)) <= RTOL


@functools.lru_cache(maxsize=None)
def type3_sets():
    rng = np.random.default_rng(5)
    x = rng.uniform(-3, 5, (64, 2)).astype(np.float32)
    t = rng.uniform(-20, 20, (48, 2)).astype(np.float32)
    c = rng.standard_normal((4, 64, 2)).astype(np.float32)
    return x, t, c


def test_sharded_nufft_type3_matches_jax():
    x, t, c = type3_sets()
    want = np.asarray(tfft.planar.Type3Plan(x, t, tol=1e-5)(c))
    got = sharded_nufft_type3(torch.from_numpy(c), x, t, cpu_mesh(),
                              tol=1e-5)
    assert got.shape == (4, 48, 2)
    assert relerr(got, want) <= RTOL


@pytest.mark.parametrize("transform_type", ["type_2", "type_1"])
def test_planned_matches_jax(transform_type):
    points, images, strengths = tensors()
    op = ShardedPlannedNufft(points, GRID, cpu_mesh(),
                             transform_type=transform_type)
    assert op._planned and op.level == "binned"
    jop = tfft.planar.PlannedNufft(problem()[0], GRID,
                                   transform_type=transform_type)
    src = strengths if transform_type == "type_1" else images
    want = np.asarray(jop(src.numpy()))
    assert relerr(op(src), want) <= RTOL
    # The adjoint: the other type, the opposite direction.
    other = "type_2" if transform_type == "type_1" else "type_1"
    adj_src = images if transform_type == "type_1" else strengths
    assert relerr(op.adjoint()(adj_src),
                  jax_nufft(other, "backward")) <= RTOL


def test_planned_normal_matches_jax():
    points, images, _ = tensors()
    w = np.random.default_rng(3).uniform(0.5, 2.0, M).astype(np.float32)
    op = ShardedPlannedNufft(points, GRID, cpu_mesh())
    got = op.normal(images, op.slot_weights(w))
    jop = tfft.planar.PlannedNufft(problem()[0], GRID)
    want = np.asarray(jop.adjoint()(jop(problem()[1]) * w[None, :, None]))
    assert relerr(got, want) <= RTOL
    assert relerr(op.normal(images), op.adjoint()(op(images))) <= RTOL


# -- the plan artifacts against the JAX ShardedPlannedNufft's ------------


def _artifact_case(case):
    """(points, grid, mats budget or None) of the 2D "mats" case (1024
    points a shard) and the rank-3 banded "binned" case (the budget
    zeroed in both packages, as tests/test_torch_slots3d.py does)."""
    rng = np.random.default_rng(11)
    if case == "mats_2d":
        return rng.uniform(-np.pi, np.pi, (4096, 2)).astype(np.float32), \
            (32, 32), None
    # Points denser in one half of axis 0, so the shards' own bands
    # differ and the uniform band re-clips some shards' origins.
    pts = rng.uniform(-np.pi, np.pi, (2048, 3)).astype(np.float32)
    pts[1024:, 0] = rng.uniform(-np.pi, 0.0, 1024).astype(np.float32)
    return pts, (16, 16, 16), 0


@pytest.mark.parametrize("case", ["mats_2d", "banded_3d"])
def test_plan_artifacts_match_jax(case, monkeypatch):
    points, grid, budget = _artifact_case(case)
    if budget is not None:
        monkeypatch.setattr(pallas_spread, "MATS_BYTES_BUDGET", budget)
        monkeypatch.setattr(tb, "MATS_BYTES_BUDGET", budget)
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("data", "points"))
    jop = JaxShardedPlannedNufft(points, grid, jmesh,
                                 transform_type="type_1",
                                 options=tfft.Options(backend="pallas"))
    op = ShardedPlannedNufft(torch.from_numpy(points), grid, cpu_mesh(),
                             transform_type="type_1")
    assert op.level == jop._level == ("mats" if budget is None
                                      else "binned")
    assert op._band == jop._band
    assert op.num_slots == jop.num_slots
    np.testing.assert_array_equal(op.slot_mask.numpy(),
                                  np.asarray(jop.slot_mask))
    binned = jop._arts[1]
    for j, shard in enumerate(op._shards):
        for name in ("padpos", "invpos", "tile_bounds"):
            np.testing.assert_array_equal(
                getattr(shard.binned, name).numpy(),
                np.asarray(getattr(binned, name)[j]))
        for got, want in zip(shard.binned.chunk_tidx, binned.chunk_tidx):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[j]))
    if budget is None:
        assert len(jop._arts) == 3
        assert all(sh.band_info is None for sh in op._shards)
        return
    # The uniform band: the largest of the shards' own, each shard's
    # origins re-clipped to it; some shard's own band was narrower.
    zorigins = jop._arts[3]
    own = [planar.PlannedNufft(block, grid, "type_1", device="cpu")
           for block in torch.from_numpy(points).reshape(4, -1, 3)]
    assert op._band == max(p.band_info.band for p in own) < op.geom.ext[0]
    assert min(p.band_info.band for p in own) < op._band
    for j, (shard, mine) in enumerate(zip(op._shards, own)):
        assert shard.band_info.band == op._band
        np.testing.assert_array_equal(shard.band_info.zorigins.numpy(),
                                      np.asarray(zorigins[j]))
        np.testing.assert_array_equal(
            shard.band_info.zorigins.numpy(),
            np.minimum(mine.band_info.zorigins.numpy(),
                       op.geom.ext[0] - op._band))


def test_band_rejected_on_one_shard(monkeypatch):
    """Three shards clustered in axis 0 keep narrow bands on the banded
    geometry; the fourth, spread over axis 0, has none there, which the
    memory model rejects, so it re-plans on the unbanded geometry. With
    the geometries different no uniform band applies: each shard keeps
    its own plan, and the applies equal the unsharded transform."""
    monkeypatch.setattr(tb, "MATS_BYTES_BUDGET", 0)
    grid, per = (64, 16, 16), 256
    rng = np.random.default_rng(13)
    pts = rng.uniform(-np.pi, np.pi, (4 * per, 3)).astype(np.float32)
    pts[:3 * per, 0] = rng.uniform(-0.3, 0.3, 3 * per)
    pts = torch.from_numpy(pts)
    op = ShardedPlannedNufft(pts, grid, cpu_mesh(), transform_type="type_1")
    own = [planar.PlannedNufft(block, grid, "type_1", device="cpu")
           for block in pts.reshape(4, per, 3)]
    assert op.level == "binned" and op._band is None
    assert own[3].band_info is None
    assert own[3].geom.ext[0] < own[0].geom.ext[0]
    for shard, mine in zip(op._shards, own):
        assert shard.geom == mine.geom
        if mine.band_info is None:
            assert shard.band_info is None
        else:
            assert shard.band_info.band == mine.band_info.band
            assert torch.equal(shard.band_info.zorigins,
                               mine.band_info.zorigins)
    src = torch.from_numpy(rng.standard_normal((2, 4 * per, 2)).astype(
        np.float32))
    assert relerr(op(src), planar.nufft(src, pts, grid, "type_1")) <= RTOL
    modes = torch.from_numpy(rng.standard_normal((2,) + grid + (2,)).astype(
        np.float32))
    assert relerr(op.adjoint()(modes), planar.nufft(
        modes, pts, fft_direction="backward")) <= RTOL


def test_planned_on_mixed_devices():
    """A mesh whose data rows name the points blocks' devices in another
    order ("cpu" and "cpu:0" are distinct mesh devices): the plan of a
    block on another device is a copy of its shard's, every tensor moved
    there, with the same slots; apply, normal and the slot surface equal
    the unsharded plan's."""
    points, images, strengths = tensors()
    mesh = Mesh([["cpu", "cpu:0"], ["cpu:0", "cpu"]], ("data", "points"))
    op = ShardedPlannedNufft(points, GRID, mesh)
    ref = planar.PlannedNufft(points, GRID, device="cpu")
    assert op._planned
    copies = [(op._plans[(i, j)], shard) for i in range(2)
              for j, shard in enumerate(op._shards)
              if op._plans[(i, j)] is not shard]
    assert copies
    for copy, shard in copies:
        for name, value in shard.__dict__.items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(getattr(copy, name), value), name
        for got, want in zip(copy.binned, shard.binned):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want)
    assert relerr(op(images), ref(images)) <= RTOL
    w = torch.linspace(0.5, 2.0, M)
    assert relerr(op.normal(images, op.slot_weights(w)),
                  ref.normal(images, ref.slot_weights(w))) <= RTOL
    assert torch.equal(op.from_slots(op.to_slots(strengths)), strengths)
    assert relerr(op.adjoint().apply_from_slots(op.apply_to_slots(images)),
                  ref.adjoint()(ref(images))) <= RTOL


# -- the port against its own unsharded transforms -----------------------


@pytest.mark.parametrize("transform_type", ["type_2", "type_1"])
def test_gradients_match_unsharded(transform_type):
    """Source and points gradients of a loss through sharded_nufft equal
    planar.nufft's (each block's core backward, summed by autograd)."""
    points, images, strengths = tensors()
    src = strengths if transform_type == "type_1" else images
    grid = GRID if transform_type == "type_1" else None
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B,) + ((M,) if transform_type == "type_2" else GRID) + (2,))
        .astype(np.float32))
    grads = []
    for fn in (lambda s, p: sharded_nufft(s, p, cpu_mesh(), grid,
                                          transform_type),
               lambda s, p: planar.nufft(s, p, grid, transform_type)):
        s, p = src.clone().requires_grad_(), points.clone().requires_grad_()
        (fn(s, p) * cot).sum().backward()
        grads.append((s.grad, p.grad))
    for got, want in zip(*grads):
        assert relerr(got, want) <= RTOL


def test_grid_and_type3_gradients():
    """The grid-sharded type-1 and the sharded type-3 are differentiable
    in their strengths, as their unsharded counterparts."""
    points, _, strengths = tensors()
    s1, s2 = (strengths.clone().requires_grad_() for _ in range(2))
    mesh = cpu_mesh((4,), ("grid",))
    (sharded_nufft_grid(s1, points, mesh, GRID, "type_1") ** 2).sum() \
        .backward()
    (planar.nufft(s2, points, GRID, "type_1") ** 2).sum().backward()
    assert relerr(s1.grad, s2.grad) <= RTOL
    with pytest.raises(ValueError, match="plan data"):
        sharded_nufft_grid(strengths, points.clone().requires_grad_(),
                           mesh, GRID, "type_1")
    # The sharded type-3's gradient is the exact transpose of its
    # pipeline: <c, 2 A^T A c> = 2 |A c|^2. The plan's backward is the
    # adjoint type-3 plan, another approximation of A^H at tol, so the
    # two agree at the JAX gradient tests' 1e-4.
    x, t, c = type3_sets()
    c1, c2 = (torch.from_numpy(c).requires_grad_() for _ in range(2))
    out = sharded_nufft_type3(c1, x, t, cpu_mesh(), tol=1e-5)
    (out ** 2).sum().backward()
    lhs = float((c1.detach().double() * c1.grad.double()).sum())
    rhs = 2 * float((out.detach().double() ** 2).sum())
    assert abs(lhs - rhs) <= RTOL * abs(rhs)
    (planar.Type3Plan(x, t, tol=1e-5, device="cpu")(c2) ** 2).sum() \
        .backward()
    assert relerr(c1.grad, c2.grad) <= 1e-4


@pytest.mark.parametrize("mesh_case", ["data_only", "inactive_data",
                                       "points_only", "repeated_devices"])
def test_meshes(mesh_case):
    """A data-only mesh, a two-axis mesh with the data axis left out
    (replicated, computed once), a points-only mesh, and a mesh of
    torch.device objects repeating one device; each equals the unsharded
    transform."""
    points, images, strengths = tensors()
    want = planar.nufft(images, points)
    if mesh_case == "data_only":
        got = sharded_nufft(images, points, cpu_mesh((4,), ("data",)),
                            points_axis=None)
    elif mesh_case == "inactive_data":
        got = sharded_nufft(images, points, cpu_mesh(), data_axis=None)
    elif mesh_case == "points_only":
        got = ShardedPlannedNufft(points, GRID, cpu_mesh((8,), ("points",)),
                                  data_axis=None)(images)
    else:
        mesh = Mesh([[torch.device("cpu")] * 2] * 2, ("data", "points"))
        assert mesh.shape == {"data": 2, "points": 2} and mesh.size == 4
        got = sharded_nufft(images, points, mesh)
        got1 = sharded_nufft(strengths, points, mesh, GRID, "type_1")
        assert relerr(got1, planar.nufft(strengths, points, GRID,
                                         "type_1")) <= RTOL
    assert got.device == images.device
    assert relerr(got, want) <= RTOL


def test_mesh_errors():
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("data", "points"))
    with pytest.raises(ValueError, match="repeat"):
        Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "data"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda:0"] * 4, ("points",))


def test_divisibility_and_shape_errors():
    """The JAX package's messages."""
    points, images, strengths = tensors()
    mesh = cpu_mesh()
    with pytest.raises(ValueError, match="divide"):
        sharded_nufft(images[:3], points, mesh)
    with pytest.raises(ValueError, match="divide"):
        sharded_nufft(images, points[:63], mesh)
    with pytest.raises(ValueError, match="must divide the leading grid "
                                         "dim 16"):
        sharded_nufft_grid(images, points, cpu_mesh((3,), ("grid",)))
    x, t, c = type3_sets()
    with pytest.raises(ValueError, match="must divide both M=63"):
        sharded_nufft_type3(torch.from_numpy(c[:, :63]), x[:63], t, mesh)
    with pytest.raises(ValueError,
                       match="num_points 63 must divide evenly over the "
                             "points axis"):
        ShardedPlannedNufft(points[:63], GRID, mesh)
    op = ShardedPlannedNufft(points, GRID, mesh)
    with pytest.raises(ValueError, match=r"batch 3 must divide evenly over "
                                         r"the data axis \(size 2\)"):
        op(images[:3])
    with pytest.raises(ValueError, match="sharded planned type_1 expects a "
                                         "source of shape"):
        op.adjoint()(images)
    with pytest.raises(ValueError, match="shard-major slot-order"):
        op.from_slots(strengths)
    with pytest.raises(ValueError, match="apply_from_slots is the type-1"):
        op.apply_from_slots(strengths)
    with pytest.raises(ValueError, match=r"weights must have shape \[64\]"):
        op.slot_weights(np.ones(63, np.float32))


def test_type3_max_batch_size_chunking():
    x, t, c = type3_sets()
    mesh = cpu_mesh((8,), ("points",))
    c = torch.from_numpy(c)
    got = sharded_nufft_type3(c, x, t, mesh, tol=1e-5, data_axis=None,
                              options=Options(max_batch_size=2))
    want = sharded_nufft_type3(c, x, t, mesh, tol=1e-5, data_axis=None)
    assert relerr(got, want) <= 1e-6


def test_unplanned_fallback():
    """backend='xla' plans nothing: every apply runs sharded_nufft."""
    points, images, strengths = tensors()
    op = ShardedPlannedNufft(points, GRID, cpu_mesh(),
                             options=Options(backend="xla"))
    assert not op._planned and op.level == "none"
    want = planar.nufft(images, points, options=Options(backend="xla"))
    assert relerr(op(images), want) <= RTOL
    assert op.num_slots == M and op.slot_mask.sum() == M
    assert torch.equal(op.to_slots(strengths), strengths)
    assert torch.equal(op.apply_to_slots(images), op(images))
    w = torch.full((M,), 2.0)
    assert relerr(op.normal(images, op.slot_weights(w)),
                  2 * op.adjoint()(op(images))) <= RTOL


def test_slot_round_trip_and_mask():
    points, _, strengths = tensors()
    op = ShardedPlannedNufft(points, GRID, cpu_mesh())
    slots = op.to_slots(strengths)
    assert slots.shape == (B, op.num_slots, 2)
    assert op.num_slots == sum(sh.num_slots for sh in op._shards)
    assert torch.equal(op.from_slots(slots), strengths)
    mask = op.slot_mask
    assert int(mask.sum()) == M
    assert torch.all(slots[:, mask == 0] == 0)


def test_slot_applies_and_gradients():
    """The slot applies equal the point-order ones through the
    conversions; their gradients are the adjoint slot applies."""
    points, images, strengths = tensors()
    t2 = ShardedPlannedNufft(points, GRID, cpu_mesh())
    t1 = t2.adjoint()
    assert torch.equal(t2.from_slots(t2.apply_to_slots(images)),
                       t2(images))
    assert relerr(t1.apply_from_slots(t1.to_slots(strengths)),
                  t1(strengths)) <= RTOL
    y = t2.apply_to_slots(images) * 0.5
    x = images.clone().requires_grad_()
    ((t2.apply_to_slots(x) - y) ** 2).sum().backward()
    want = 2.0 * t1.apply_from_slots(t2.apply_to_slots(images) - y)
    assert relerr(x.grad, want) <= RTOL
    v = t1.to_slots(strengths).requires_grad_()
    t1.from_slots(v).sum().backward()
    assert torch.equal(v.grad, t1.to_slots(torch.ones_like(strengths)))


def test_normal_gradient_is_self_adjoint():
    points, images, _ = tensors()
    op = ShardedPlannedNufft(points, GRID, cpu_mesh())
    w = torch.linspace(0.5, 2.0, M)
    sw = op.slot_weights(w)
    ct = torch.ones_like(images)
    x = images.clone().requires_grad_()
    (op.normal(x, sw) * ct).sum().backward()
    assert relerr(x.grad, op.normal(ct, sw)) <= RTOL
    # And through the planned apply and normal, as the dry run's loss.
    ref = planar.PlannedNufft(points, GRID, device="cpu")
    grads = []
    for fwd, nrm in ((op, lambda s: op.normal(s, sw)),
                     (ref, lambda s: ref.normal(s, ref.slot_weights(w)))):
        x = images.clone().requires_grad_()
        ((fwd(x) ** 2).sum() + (nrm(x) ** 2).sum()).backward()
        grads.append(x.grad)
    assert relerr(*grads) <= RTOL
