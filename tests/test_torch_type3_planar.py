"""The port's planar type-3 plan against the JAX package's.

``tnt.planar.Type3Plan`` plans its outer spread by the JAX package's rule
(``_spread_level`` "mats", "binned" or "none", the dense-matrix budget
split between the outer spread and the inner type-2 with a 16 MiB
margin), so with the budget lowered (both packages', as
``tests/test_torch_zorder.py`` lowers it) both plans take the same level
in each branch of the split, the same outer geometry, and an inner
``PlannedNufft`` of the same level, geometry and band. On CPU tensors
(the kernels' plain versions) its outputs at ranks 1-3 match the JAX
plan's with ``backend='pallas'`` (interpret mode) within 1e-5 of the
peak; its gradient is the adjoint plan's apply, bit for bit, and matches
``jax.vjp`` of the JAX plan.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tests.torch_threads import one_torch_thread  # noqa: F401

MARGIN = 16 * 2 ** 20
PALLAS = tfft.Options(backend="pallas")


def relerr(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def sets(rank, m=200, k=150, seed=4):
    """Points in [-pi, pi), targets in [-16, 16) (rank 3: [-2, 2), the
    smallest fine grid, 16^3) and strengths [2, M, 2], float32."""
    rng = np.random.default_rng(seed)
    span = 2.0 if rank == 3 else 16.0
    x = rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32)
    t = rng.uniform(-span, span, (k, rank)).astype(np.float32)
    c = rng.standard_normal((2, m, 2)).astype(np.float32)
    return x, t, c


def _geom(g):
    return (g.fine_shape, g.tile, g.pad, g.chunk, g.num_chunks)


def _budget(monkeypatch, budget):
    monkeypatch.setattr(pallas_spread, "MATS_BYTES_BUDGET", budget)
    monkeypatch.setattr(tb, "MATS_BYTES_BUDGET", budget)


def _outer_bytes(x, t):
    op = tnt.planar.Type3Plan(x, t, device="cpu")
    return tb.mats_payload_bytes(op.geom)


def assert_same_plan(top, jop):
    assert top.fine_shape == jop.fine_shape
    assert top._spread_level == jop._spread_level
    if top._spread_level != "none":
        assert _geom(top.geom) == _geom(jop.geom)
        assert top.binned.invpos.shape[0] == jop.binned.invpos.shape[0]
    ti, ji = top._inner_t2, jop._inner_t2
    assert ti.level == (ji._level if ji._planned else "none")
    if ti.level != "none":
        assert _geom(ti.geom) == _geom(ji.geom)
        assert ti.num_slots == ji.num_slots
        if ji.band_info is None:
            assert ti.band_info is None
        else:
            assert ti.band_info.band == ji.band_info[0]
            np.testing.assert_array_equal(ti.band_info.zorigins.numpy(),
                                          np.asarray(ji.band_info[1]))


@pytest.mark.parametrize("branch,rank", [
    ("both_fit", 2),          # default budget: both stages at "mats"
    ("inner_streams", 2),     # the inner does not fit: the outer takes mats
    ("binned", 2),            # nothing fits: the outer streams coords
    ("binned", 3),            # ... with a banded inner type-2
    ("none", 2),              # backend='xla': nothing is planned
])
def test_levels_match_jax(monkeypatch, branch, rank):
    x, t, _ = sets(rank)
    options = PALLAS
    if branch == "inner_streams":
        # inner_need > budget - margin and outer + margin <= budget.
        _budget(monkeypatch, MARGIN + _outer_bytes(x, t))
    elif branch == "binned":
        _budget(monkeypatch, 0)
    elif branch == "none":
        options = tfft.Options(backend="xla")
    jop = tfft.planar.Type3Plan(x, t, options=options)
    top = tnt.planar.Type3Plan(
        x, t, options=tnt.Options(backend=options.backend), device="cpu")
    assert_same_plan(top, jop)
    want_level = {"both_fit": "mats", "inner_streams": "mats",
                  "binned": "binned", "none": "none"}[branch]
    assert top._spread_level == want_level


def test_binned_outputs_match_jax(monkeypatch):
    """The "binned" branch end to end: the outer spread from coords, the
    inner type-2 at its binned level."""
    _budget(monkeypatch, 0)
    x, t, c = sets(2)
    jop = tfft.planar.Type3Plan(x, t, options=PALLAS)
    top = tnt.planar.Type3Plan(x, t, device="cpu")
    assert top._spread_level == top._inner_t2.level == "binned"
    assert relerr(top(torch.from_numpy(c)), jop(c)) <= 1e-5


@functools.lru_cache(maxsize=None)
def jax_output(rank, direction):
    x, t, c = sets(rank)
    jop = tfft.planar.Type3Plan(x, t, fft_direction=direction,
                                options=PALLAS)
    return jop._spread_level, np.asarray(jop(c))


@pytest.mark.parametrize("rank,direction", [
    (1, "forward"), (2, "backward"), (3, "forward")])
def test_outputs_match_jax_pallas(rank, direction):
    x, t, c = sets(rank)
    level, want = jax_output(rank, direction)
    top = tnt.planar.Type3Plan(x, t, fft_direction=direction, device="cpu")
    assert top._spread_level == level == "mats"
    got = top(torch.from_numpy(c))
    assert got.shape == (2, t.shape[0], 2) and got.dtype == torch.float32
    assert relerr(got, want) <= 1e-5
    # The one-shot form builds the same plan.
    one = tnt.planar.nufft_type3(torch.from_numpy(c), torch.from_numpy(x),
                                 torch.from_numpy(t), direction)
    assert torch.equal(one, got)
    exact = tnt.planar.nudft_type3(torch.from_numpy(c).double(),
                                   torch.from_numpy(x).double(),
                                   torch.from_numpy(t).double(), direction)
    assert relerr(got, exact) <= 1e-5


def test_gradient_is_adjoint_and_matches_jax_vjp():
    x, t, c = sets(1)
    ct = np.random.default_rng(8).standard_normal(
        (2, t.shape[0], 2)).astype(np.float32)
    jop = tfft.planar.Type3Plan(x, t)
    _, vjp = jax.vjp(jop, c)
    want, = vjp(ct)
    top = tnt.planar.Type3Plan(x, t, device="cpu")
    src = torch.from_numpy(c).requires_grad_()
    top(src).backward(torch.from_numpy(ct))
    adj = top.adjoint()
    assert adj.num_points == t.shape[0] and adj.num_targets == x.shape[0]
    assert adj.adjoint() is top
    assert torch.equal(src.grad, adj(torch.from_numpy(ct)))
    assert relerr(src.grad, want) <= 1e-5


def test_max_batch_size_chunking():
    x, t, _ = sets(1)
    c = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, x.shape[0], 2)).astype(np.float32))
    chunked = tnt.planar.Type3Plan(x, t, options=tnt.Options(
        max_batch_size=2), device="cpu")
    whole = tnt.planar.Type3Plan(x, t, device="cpu")
    np.testing.assert_allclose(chunked(c).numpy(), whole(c).numpy(),
                               rtol=1e-6, atol=1e-6)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, t.shape[0], 2)).astype(np.float32))
    grads = []
    for op in (chunked, whole):
        src = c.clone().requires_grad_()
        (op(src) * ct).sum().backward()
        grads.append(src.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5)
