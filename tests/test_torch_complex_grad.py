"""Gradients of the port's complex API against the JAX package.

For a real loss, PyTorch's gradient with respect to a complex source is
dL/dRe + i dL/dIm, the conjugate of ``jax.grad``'s; the points gradient
is real and equal to JAX's. Both CPU routes of the port (plain versions
and the XLA path), both types and directions, complex64 and complex128,
and the spread-only ops. The JAX gradients run in one ``jax.jit`` (the
JAX package's XLA path: within 1e-15 of the eager gradients in
complex128 and 3e-7 in complex64, at a twentieth of the time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_complex_cases import (
    BACKENDS, M, REAL, SPREAD_GRIDS, TOL, case, complex_normal, opts, relerr)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _loss_jax(fn, src, pts, weights):
    def loss(s, p):
        out = fn(s, p)
        return jnp.sum(out.real * weights[0] + out.imag * weights[1])
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(src),
                                                   jnp.asarray(pts))


def _loss_torch(fn, src, pts, weights):
    s = torch.from_numpy(src).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    out = fn(s, p)
    w = torch.from_numpy(weights)
    (out.real * w[0] + out.imag * w[1]).sum().backward()
    return s.grad, p.grad


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("transform_type,direction", [
    ("type_1", "forward"), ("type_1", "backward"), ("type_2", "forward"),
    ("type_2", "backward")])
def test_nufft_gradients_match_jax(transform_type, direction, dtype):
    """Source gradient = conj(jax.grad), points gradient = jax.grad, on
    both CPU routes."""
    grid, pts, src = case(2, M, transform_type, dtype, 8)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction=direction,
              tol=TOL[dtype])
    out_shape = grid if transform_type == "type_1" else (M,)
    weights = np.random.default_rng(9).standard_normal(
        (2,) + out_shape).astype(REAL[dtype])
    js, jp = _loss_jax(lambda s, p: tfft.nufft(s, p, **kw), src, pts,
                       weights)
    rtol = 1e-4 if dtype == np.complex64 else 1e-9
    for backend in BACKENDS:
        ts, tp = _loss_torch(lambda s, p: tnt.nufft(
            s, p, options=opts(backend), **kw), src, pts, weights)
        assert relerr(ts, np.conj(np.asarray(js))) <= rtol, backend
        assert relerr(tp, jp) <= rtol, backend


@pytest.mark.parametrize("op,rank", [("interp", 2), ("spread", 2),
                                     ("interp", 3), ("spread", 1)])
def test_spread_only_gradients_match_jax(op, rank):
    grid = SPREAD_GRIDS[rank]
    rng = np.random.default_rng(11)
    pts = rng.uniform(-np.pi, np.pi, (M, rank)).astype(np.float64)
    if op == "interp":
        src = complex_normal(rng, grid, np.complex128)
        out_shape = (M,)
    else:
        src = complex_normal(rng, (M,), np.complex128)
        out_shape = grid
    args = () if op == "interp" else (grid,)
    weights = rng.standard_normal((2,) + out_shape)
    js, jp = _loss_jax(lambda s, p: getattr(tfft, op)(s, p, *args,
                                                     tol=1e-10),
                       src, pts, weights)
    for backend in BACKENDS:
        ts, tp = _loss_torch(lambda s, p: getattr(tnt, op)(
            s, p, *args, tol=1e-10, options=opts(backend)), src, pts,
            weights)
        assert relerr(ts, np.conj(np.asarray(js))) <= 1e-9, backend
        assert relerr(tp, jp) <= 1e-8, backend


