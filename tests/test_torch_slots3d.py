"""The port's slot-order surface at the rank-3 binned level against the
JAX package's.

With both packages' dense-matrix budget lowered, the type-2 plans take
the binned level at a small 3D size (grid (8, 8, 16), 1000 points):
z-ordered binning with an axis-0 band. There ``normal`` runs the banded
interp in chunk order, then the fused banded spread from slot-order
values; ``apply_to_slots`` the chunk-order interp, and its gradient
``apply_from_slots`` on the adjoint plan. Each result and gradient is
held to ``jax.vjp`` of the JAX call (Pallas kernels in interpret mode)
to 1e-5 of the peak, and the conversions to the JAX package's exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (8, 8, 16)
M = 1000
RTOL = 1e-5


def _relerr(got, want):
    got = np.asarray(got.detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def plans():
    pts = np.random.default_rng(7).uniform(
        -np.pi, np.pi, (M, 3)).astype(np.float32)
    budgets = pallas_spread.MATS_BYTES_BUDGET, tb.MATS_BYTES_BUDGET
    pallas_spread.MATS_BYTES_BUDGET = tb.MATS_BYTES_BUDGET = 0
    try:
        jop = tfft.planar.PlannedNufft(pts, GRID, transform_type="type_2",
                                       options=tfft.Options(backend="pallas"))
        top = tnt.PlannedNufft(pts, GRID, transform_type="type_2",
                               device="cpu")
    finally:
        pallas_spread.MATS_BYTES_BUDGET, tb.MATS_BYTES_BUDGET = budgets
    assert jop._level == top.level == "binned"
    assert top.band_info is not None
    assert top.band_info.band == jop.band_info[0] < top.geom.ext[0]
    np.testing.assert_array_equal(top.binned.invpos.numpy(),
                                  np.asarray(jop.binned.invpos))
    return jop, top


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(input, cotangent, weights, JAX output, JAX vjp)."""
    jop = plans()[0]
    x = _data(1, (1,) + GRID + (2,))
    w = np.random.default_rng(2).uniform(0.5, 1.5, M).astype(np.float32)
    if name == "normal":
        fn = functools.partial(jop.normal, slot_w=jop.slot_weights(w))
        ct = _data(3, x.shape)
    else:
        fn = jop.apply_to_slots
        ct = _data(4, (1, jop.num_slots, 2))
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return x, ct, w, np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("name", ("normal", "apply_to_slots"))
def test_binned_slot_op_and_gradient_match_jax(name):
    top = plans()[1]
    x, ct, w, want, want_grad = jax_case(name)
    src = torch.from_numpy(x.copy()).requires_grad_()
    if name == "normal":
        out = top.normal(src, top.slot_weights(w))
    else:
        out = top.apply_to_slots(src)
        used = int(top.binned.tile_bounds[-1]) * top.geom.chunk
        assert not out[:, used:].any()     # unused chunks: exactly zero
    out.backward(torch.from_numpy(ct))
    assert _relerr(out, want) <= RTOL
    assert _relerr(src.grad, want_grad) <= RTOL


def test_binned_conversions_match_jax():
    jop, top = plans()
    vals = _data(5, (2, M, 2))
    slots = top.to_slots(torch.from_numpy(vals))
    np.testing.assert_array_equal(slots.numpy(),
                                  np.asarray(jop.to_slots(vals)))
    np.testing.assert_array_equal(top.from_slots(slots).numpy(), vals)
    w = np.random.default_rng(6).uniform(0.5, 1.5, M).astype(np.float32)
    np.testing.assert_array_equal(top.slot_weights(w).numpy(),
                                  np.asarray(jop.slot_weights(w)))
