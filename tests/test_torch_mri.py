"""The port's MRI models against the JAX package.

``tnt.models.mri`` on CPU tensors (the kernels' plain versions) against
``tfft.models.mri`` on the same numpy inputs: the generators equal, the
SENSE operator within 1e-5 of the peak, CG-SENSE within 1e-4 and the
Pipe-Menon weights within 1e-4 relative (``test_torch_toeplitz.py``
holds the Toeplitz operator alone).
"""

import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.models import mri as jmri
from tensorflow_nufft_tpu_torch.models import mri
from tests.torch_complex_cases import relerr
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (32, 32)
COILS = 4
SPOKES, SAMPLES = 16, 64


def _sense_inputs(dtype=np.float32):
    pts = mri.radial_trajectory(SPOKES, SAMPLES, dtype=dtype)
    maps = mri.birdcage_maps(COILS, GRID, dtype=dtype)
    img = mri.shepp_logan(GRID, dtype=dtype)
    density = mri.radial_density(SPOKES, SAMPLES, dtype=dtype)
    return pts, maps, img, density


def test_generators_equal_jax():
    for ours, ref in (
            (mri.radial_trajectory(12, 40), jmri.radial_trajectory(12, 40)),
            (mri.radial_trajectory(12, 40, golden_angle=True),
             jmri.radial_trajectory(12, 40, golden_angle=True)),
            (mri.radial_density(12, 40), jmri.radial_density(12, 40)),
            (mri.birdcage_maps(8, (24, 20)), jmri.birdcage_maps(8, (24, 20))),
            (mri.shepp_logan((24, 20), np.float64),
             jmri.shepp_logan((24, 20), np.float64))):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_planar_helpers_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3, 2)).astype(np.float32)
    b = rng.standard_normal((5, 3, 2)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for ours, ref in ((mri.pmul(ta, tb), jmri.pmul(a, b)),
                      (mri.pconj(ta), jmri.pconj(a)),
                      (mri.pabs2(ta), jmri.pabs2(a))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("planned,with_density", [
    (True, True), (True, False), (False, True), (False, False)])
def test_sense_matches_jax(planned, with_density):
    pts, maps, img, density = _sense_inputs()
    density = density if with_density else None
    ref = jmri.SenseNufft(pts, maps, GRID, density=density, planned=planned)
    op = mri.SenseNufft(pts, maps, GRID, density=density, planned=planned,
                        device="cpu")
    if planned:
        assert op._t2.level != "none"
    ksp = np.random.default_rng(1).standard_normal(
        (COILS, pts.shape[0], 2)).astype(np.float32)
    assert relerr(op.forward(img), np.asarray(ref.forward(img))) <= 1e-5
    assert relerr(op.adjoint(ksp), np.asarray(ref.adjoint(ksp))) <= 1e-5
    assert relerr(op.normal(img), np.asarray(ref.normal(img))) <= 1e-5


def test_sense_float64_takes_the_composed_normal():
    """Float64 points plan at level "none", so ``normal`` is the composed
    pair, as in the JAX package."""
    pts, maps, img, density = _sense_inputs(np.float64)
    op = mri.SenseNufft(pts, maps, GRID, density=density, tol=1e-12,
                        device="cpu")
    assert op._t2.level == "none" and op._slot_density is None
    ref = jmri.SenseNufft(pts, maps, GRID, density=density, tol=1e-12)
    assert relerr(op.normal(img), np.asarray(ref.normal(img))) <= 1e-10


@pytest.mark.parametrize("toeplitz", [False, True])
def test_cg_sense_matches_jax(toeplitz):
    pts, maps, img, density = _sense_inputs()
    ref_op = jmri.SenseNufft(pts, maps, GRID, density=density,
                             toeplitz=toeplitz)
    op = mri.SenseNufft(pts, maps, GRID, density=density, toeplitz=toeplitz,
                        device="cpu")
    if toeplitz:
        assert relerr(op._toeplitz.spectrum,
                      np.asarray(ref_op._toeplitz.spectrum)) <= 1e-5
    ksp = np.asarray(ref_op.forward(img))
    want = np.asarray(jmri.cg_sense(ksp, ref_op, num_iters=8))
    got = mri.cg_sense(torch.tensor(ksp), op, num_iters=8)
    assert relerr(got, want) <= 1e-4
    # CG-SENSE reconstructs the phantom from its own data.
    assert np.linalg.norm(got.numpy() - img) / np.linalg.norm(img) < 0.5


def test_cg_sense_gradient_finite():
    """As ``test_cg_sense_jit_and_grad``: a reconstruction loss
    backpropagates to the k-space data."""
    grid = (16, 16)
    pts = mri.radial_trajectory(24, 32)
    op = mri.SenseNufft(pts, mri.birdcage_maps(2, grid), grid, device="cpu")
    phantom = torch.from_numpy(mri.shepp_logan(grid))
    kspace = op.forward(phantom).detach().requires_grad_()
    rec = mri.cg_sense(kspace, op, num_iters=5)
    loss = ((rec - phantom) ** 2).sum()
    loss.backward()
    assert bool(torch.isfinite(loss)) and bool(
        torch.isfinite(kspace.grad).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pipe_menon_matches_jax(dtype):
    pts = mri.radial_trajectory(32, 64, dtype=dtype)
    want = np.asarray(jmri.pipe_menon_density(pts, GRID, num_iters=10))
    got = mri.pipe_menon_density(pts, GRID, num_iters=10, device="cpu")
    assert got.dtype == torch.from_numpy(pts).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert abs(float(got.sum()) - 1.0) < 1e-5
