"""The port's Toeplitz-embedded normal operator against the JAX package.

``tnt.planar.ToeplitzNormal`` on CPU tensors against
``tfft.planar.ToeplitzNormal`` on the same numpy inputs: the spectrum and
the apply within 1e-5 of the peak at float32 and 1e-10 at float64, and
the apply's gradient (the operator is self-adjoint).
"""

import jax
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_complex_cases import relerr
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype,tol,rtol", [(np.float32, 1e-6, 1e-5),
                                            (np.float64, 1e-12, 1e-10)])
@pytest.mark.parametrize("grid,direction,weighted", [
    ((16, 20), "forward", True), ((16, 20), "backward", False),
    ((24,), "forward", True), ((6, 8, 10), "forward", True)])
def test_toeplitz_matches_jax(grid, direction, weighted, dtype, tol, rtol):
    rng = np.random.default_rng(len(grid))
    m = 300
    pts = rng.uniform(-np.pi, np.pi, (m, len(grid))).astype(dtype)
    w = rng.uniform(0.5, 1.5, m).astype(dtype) if weighted else None
    kw = dict(weights=w, fft_direction=direction, tol=tol)
    ref = tfft.planar.ToeplitzNormal(pts, grid, **kw)
    op = tnt.planar.ToeplitzNormal(pts, grid, device="cpu", **kw)
    assert op.spectrum.dtype == torch.from_numpy(pts).dtype
    assert relerr(op.spectrum, np.asarray(ref.spectrum)) <= rtol
    x = rng.standard_normal((2,) + grid + (2,)).astype(dtype)
    assert relerr(op(torch.from_numpy(x)), np.asarray(jax.jit(ref)(x))) <= rtol
    # The operator is its own transpose: the gradient of <op(x), y> is
    # op(y).
    y = rng.standard_normal((2,) + grid + (2,)).astype(dtype)
    xt = torch.from_numpy(x).requires_grad_()
    (op(xt) * torch.from_numpy(y)).sum().backward()
    assert relerr(xt.grad, op(torch.from_numpy(y)).numpy()) <= rtol
