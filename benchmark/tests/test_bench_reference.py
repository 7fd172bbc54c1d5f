"""The plain reference against the NUDFT and CG definitions, at tiny
sizes."""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import mri_data, nudft, sense
from benchmark.reference.precision import FLOAT64, TF32, round_tf32


def _points(rng, m, rank):
    return torch.from_numpy(rng.uniform(-np.pi, np.pi, (m, rank)))


def _complex(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


def _modes(grid):
    """[N, rank] frequencies of every mode, CMCL order, as loops."""
    return np.array([[i - n // 2 for i, n in zip(idx, grid)]
                     for idx in itertools.product(*(range(n) for n in grid))])


def _dense(points, grid, sign):
    """[M, N] matrix exp(sign i x.k), term by term."""
    k = _modes(grid)
    x = points.numpy()
    return np.exp(sign * 1j * (x @ k.T))


@pytest.mark.parametrize("grid", [(6, 4), (4, 6, 2)])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_type1_and_type2_subsets_are_the_definition(grid, sign):
    rng = np.random.default_rng(1)
    pts = _points(rng, 37, len(grid))
    a = _dense(pts, grid, sign)
    c = _complex(rng, (2, 37))
    f = _complex(rng, (2,) + grid)
    idx = torch.tensor([0, 3, 5, math.prod(grid) - 1])
    want1 = c.numpy() @ a[:, idx.numpy()]
    got1 = nudft.exact_type1_subset(pts, c, idx, grid, sign, chunk=10)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=0, atol=1e-11)
    pidx = torch.tensor([1, 7, 36])
    want2 = f.reshape(2, -1).numpy() @ a[pidx.numpy()].T
    got2 = nudft.exact_type2_subset(pts, f, pidx, sign, chunk=5)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=0, atol=1e-11)


@pytest.mark.parametrize("grid", [(6, 4), (4, 6, 2), (5,)])
def test_type2_separable_is_the_definition(grid):
    rng = np.random.default_rng(2)
    pts = _points(rng, 41, len(grid))
    f = _complex(rng, (3,) + grid)
    want = f.reshape(3, -1).numpy() @ _dense(pts, grid, -1.0).T
    got = nudft.type2_separable(pts, f, -1.0, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)


def test_type1_full_2d_is_the_definition():
    rng = np.random.default_rng(3)
    grid = (6, 4)
    pts = _points(rng, 29, 2)
    c = _complex(rng, (2, 29))
    want = (c.numpy() @ _dense(pts, grid, 1.0)).reshape((2,) + grid)
    got = nudft.type1_full_2d(pts, c, grid, 1.0, chunk=7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = round_tf32(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -3.0])
    assert torch.equal(got, want)
    z = torch.tensor([1 + 2 ** -12 + 1j * (2 + 2 ** -8)],
                     dtype=torch.complex64)
    assert TF32.operand(z).item() == 1 + 1j * (2 + 2 ** -8)
    assert FLOAT64.operand(z).dtype == torch.complex128


def test_sense_adjoint_is_the_adjoint():
    rng = np.random.default_rng(4)
    grid, coils = (6, 6), 3
    pts = _points(rng, 50, 2)
    maps = _complex(rng, (coils,) + grid)
    op = sense.Sense(pts, maps)
    x, y = _complex(rng, grid), _complex(rng, (coils, 50))
    lhs = torch.vdot(op.forward(x).reshape(-1), y.reshape(-1))
    rhs = torch.vdot(x.reshape(-1), op.adjoint(y).reshape(-1))
    assert abs(lhs - rhs) < 1e-9 * abs(lhs)


def test_cg_sense_solves_the_normal_equations():
    """Past the dimension of the real system, CG reaches the solution of
    A^H W A x = A^H W y, computed densely."""
    rng = np.random.default_rng(5)
    grid, coils, m = (4, 4), 2, 40
    pts = _points(rng, m, 2)
    maps = _complex(rng, (coils,) + grid)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, m))
    y = _complex(rng, (coils, m))
    a = np.concatenate([_dense(pts, grid, -1.0) * maps[c].reshape(-1).numpy()
                        for c in range(coils)])            # [C M, N]
    wd = np.tile(w.numpy(), coils)
    normal = a.conj().T @ (wd[:, None] * a)
    want = np.linalg.solve(normal, a.conj().T @ (wd * y.reshape(-1).numpy()))
    got = sense.cg_sense(y, sense.Sense(pts, maps, w), num_iters=64)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def test_mri_data():
    pts = mri_data.radial_trajectory(8, 32, "cpu")
    assert pts.shape == (256, 2)
    assert float(pts.abs().max()) <= math.pi + 1e-12
    np.testing.assert_allclose(pts[16].numpy(), [0.0, 0.0])
    w = mri_data.ramp_density(8, 32, "cpu")
    assert w.shape == (256,) and float(w.sum()) == pytest.approx(1.0)
    maps = mri_data.coil_maps(5, (16, 12), "cpu")
    sos = torch.sqrt(torch.sum(maps.abs() ** 2, dim=0))
    np.testing.assert_allclose(sos.numpy(), 1.0, rtol=1e-12)
    img = mri_data.phantom((32, 32), "cpu")
    assert img.shape == (32, 32) and float(img.real.max()) > 0
    assert float(img.imag.abs().max()) == 0.0
