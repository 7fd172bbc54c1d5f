"""The port's slot-order surface of ``PlannedNufft`` against the JAX
package's, at rank 2 (the "mats" plan level).

The planned kernels' native point layout is the chunk-padded slot stream;
``apply_to_slots``/``apply_from_slots`` skip the point-order gathers,
``to_slots``/``from_slots`` convert fixed data once, and ``normal`` is
A^H W A with the point values kept in slot order. The cases of the JAX
package's ``tests/test_slots.py``: each port result against the JAX
result on the same numpy inputs, and each gradient against ``jax.vjp``
of the JAX call, to 1e-5 of the peak (float32 summation order), plus the
port's own identities. The rank-2 "binned" level (budgets lowered)
feeds slot-order values to the split spread; the plan level "none"
(float64 points here, as in the JAX package) is held to the JAX
package's point-order fallback.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (16, 16)
M = 300
RTOL = 1e-5
PALLAS = tfft.Options(backend="pallas")


def _relerr(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@functools.lru_cache(maxsize=None)
def plans():
    """(JAX type-2 plan, port type-2 plan, points) at the mats level."""
    pts = np.random.default_rng(11).uniform(
        -np.pi, np.pi, (M, 2)).astype(np.float32)
    jop = tfft.planar.PlannedNufft(pts, GRID, transform_type="type_2",
                                   options=PALLAS)
    top = tnt.PlannedNufft(pts, GRID, transform_type="type_2", device="cpu")
    assert jop._planned and jop._level == top.level == "mats"
    return jop, top, pts


def _data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(input, cotangent, JAX output, JAX vjp) of one slot operation."""
    jop, top, _ = plans()
    grid_in = _data(1, (2,) + GRID + (2,))
    weights = np.random.default_rng(2).uniform(0.5, 1.5, M).astype(
        np.float32)
    fns = {
        "apply_to_slots": (jop.apply_to_slots, grid_in,
                           (2, jop.num_slots, 2)),
        "apply_from_slots": (jop.adjoint().apply_from_slots,
                             np.asarray(jop.to_slots(_data(3, (2, M, 2)))),
                             GRID),
        "normal": (lambda x: jop.normal(x, jop.slot_weights(weights)),
                   grid_in, GRID),
        "normal_unweighted": (jop.normal, grid_in, GRID),
        "to_slots": (jop.to_slots, _data(4, (2, M, 2)),
                     (2, jop.num_slots, 2)),
        "from_slots": (jop.from_slots, _data(5, (2, jop.num_slots, 2)),
                       (2, M, 2)),
    }
    fn, x, out_shape = fns[name]
    out_shape = out_shape if len(out_shape) == 3 else (2,) + out_shape + (2,)
    ct = _data(6, out_shape)
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return x, ct, np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0]), \
        weights


def _port_call(top, name, weights):
    return {
        "apply_to_slots": top.apply_to_slots,
        "apply_from_slots": top.adjoint().apply_from_slots,
        "normal": lambda x: top.normal(x, top.slot_weights(weights)),
        "normal_unweighted": top.normal,
        "to_slots": top.to_slots,
        "from_slots": top.from_slots,
    }[name]


@pytest.mark.parametrize("name", (
    "apply_to_slots", "apply_from_slots", "normal", "normal_unweighted",
    "to_slots", "from_slots"))
def test_slot_op_and_gradient_match_jax(name):
    top = plans()[1]
    x, ct, want, want_grad, weights = jax_case(name)
    src = torch.from_numpy(x.copy()).requires_grad_()
    out = _port_call(top, name, weights)(src)
    out.backward(torch.from_numpy(ct))
    assert _relerr(out, want) <= RTOL
    assert _relerr(src.grad, want_grad) <= RTOL


def test_slot_round_trip_and_dead_slots():
    top = plans()[1]
    vals = torch.from_numpy(_data(7, (3, M, 2)))
    slots = top.to_slots(vals)
    assert slots.shape == (3, top.num_slots, 2)
    assert torch.equal(top.from_slots(slots), vals)
    mask = top.slot_mask
    assert int(mask.sum()) == M
    assert not slots[:, mask == 0].any()


def test_apply_from_slots_ignores_dead_slots():
    """Garbage, even NaN, in padded and unused input slots must not
    leak (torch.where, not a multiply)."""
    t1 = plans()[1].adjoint()
    slots = t1.to_slots(torch.from_numpy(_data(8, (1, M, 2))))
    poisoned = slots.clone()
    poisoned[:, t1.slot_mask == 0] = float("nan")
    got = t1.apply_from_slots(poisoned)
    assert torch.isfinite(got).all()
    assert torch.equal(got, t1.apply_from_slots(slots))


def test_slot_pair_adjoint_and_normal_composition():
    """<A_s x, y> == <x, A_s^H y>; normal == apply_from_slots(W *
    apply_to_slots)."""
    t2 = plans()[1]
    t1 = t2.adjoint()
    x = torch.from_numpy(_data(9, (1,) + GRID + (2,)))
    y = t1.to_slots(torch.from_numpy(_data(10, (1, M, 2))))
    lhs = torch.sum(t2.apply_to_slots(x).double() * y.double())
    rhs = torch.sum(x.double() * t1.apply_from_slots(y).double())
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))
    w = t2.slot_weights(torch.rand(M, generator=torch.Generator()
                                   .manual_seed(0)) + 0.5)
    via = t1.apply_from_slots(t2.apply_to_slots(x) * w[None, :, None])
    assert _relerr(t2.normal(x, w), via.detach()) <= RTOL


def test_wrong_type_or_shape_raises():
    t2 = plans()[1]
    t1 = t2.adjoint()
    src = torch.zeros((1,) + GRID + (2,))
    vals = torch.zeros(1, t2.num_slots, 2)
    with pytest.raises(ValueError, match="type-2"):
        t1.apply_to_slots(src)
    with pytest.raises(ValueError, match="type-1"):
        t2.apply_from_slots(vals)
    with pytest.raises(ValueError, match="expects"):
        t2.apply_to_slots(vals)
    with pytest.raises(ValueError, match="expects"):
        t1.apply_from_slots(src)


@functools.lru_cache(maxsize=None)
def binned_case():
    """The rank-2 binned level (both budgets lowered): the JAX plan
    spreads slot-order values with its split spread (row 5 here), the
    port with its unplanned kernel's plain version."""
    from tensorflow_nufft_tpu.kernels import pallas_spread
    from tensorflow_nufft_tpu_torch.kernels import binning
    pts = plans()[2]
    budgets = pallas_spread.MATS_BYTES_BUDGET, binning.MATS_BYTES_BUDGET
    pallas_spread.MATS_BYTES_BUDGET = binning.MATS_BYTES_BUDGET = 0
    try:
        jop = tfft.planar.PlannedNufft(pts, GRID, transform_type="type_2",
                                       options=PALLAS)
        top = tnt.PlannedNufft(pts, GRID, transform_type="type_2",
                               device="cpu")
    finally:
        pallas_spread.MATS_BYTES_BUDGET, binning.MATS_BYTES_BUDGET = budgets
    assert jop._level == top.level == "binned" and top.band_info is None
    x = _data(11, (1,) + GRID + (2,))
    w = np.random.default_rng(12).uniform(0.5, 1.5, M).astype(np.float32)
    slots = np.asarray(jop.to_slots(_data(13, (1, M, 2))))
    want = (np.asarray(jop.normal(x, jop.slot_weights(w))),
            np.asarray(jop.adjoint().apply_from_slots(slots)))
    return top, x, w, slots, want


def test_binned_level_slot_order_spread_matches_jax():
    top, x, w, slots, (want_normal, want_slots) = binned_case()
    got = top.normal(torch.from_numpy(x), top.slot_weights(w))
    assert _relerr(got, want_normal) <= RTOL
    got = top.adjoint().apply_from_slots(torch.from_numpy(slots.copy()))
    assert _relerr(got, want_slots) <= RTOL


@functools.lru_cache(maxsize=None)
def fallback_case():
    """JAX's level "none" on float64 points (its Pallas path is float32
    only): slot order is point order."""
    rng = np.random.default_rng(12)
    pts = rng.uniform(-np.pi, np.pi, (100, 2))
    src = rng.standard_normal((1,) + GRID + (2,))
    w = rng.uniform(0.5, 1.5, 100)
    jop = tfft.planar.PlannedNufft(pts, GRID, transform_type="type_2")
    assert not jop._planned and jop.num_slots == 100
    return pts, src, w, (np.asarray(jop.apply_to_slots(src)),
                         np.asarray(jop.normal(src, jop.slot_weights(w))))


def test_level_none_falls_back_to_point_order():
    pts, src, w, (want_slots, want_normal) = fallback_case()
    op = tnt.PlannedNufft(pts, GRID, transform_type="type_2", device="cpu")
    assert op.level == "none" and op.num_slots == 100
    assert torch.equal(op.slot_mask, torch.ones(100, dtype=torch.float64))
    x = torch.from_numpy(src)
    assert _relerr(op.apply_to_slots(x), want_slots) <= 1e-9
    assert _relerr(op.normal(x, op.slot_weights(w)), want_normal) <= 1e-9
    vals = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 100, 2)))
    assert torch.equal(op.to_slots(vals), vals)
    assert torch.equal(op.from_slots(vals), vals)
