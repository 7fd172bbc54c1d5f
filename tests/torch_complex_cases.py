"""Seeded cases and tolerances shared by the complex-API tests of the
port (``tests/test_torch_complex*.py``, ``test_torch_broadcast.py``,
``test_torch_xla_ops.py``)."""

import numpy as np
import torch

import tensorflow_nufft_tpu_torch as tnt

RTOL = {np.complex64: 1e-5, np.complex128: 1e-10}
TOL = {np.complex64: 1e-6, np.complex128: 1e-12}
REAL = {np.complex64: np.float32, np.complex128: np.float64}
GRIDS = {1: (32,), 2: (16, 20), 3: (8, 12, 10)}
# Spread-only grids: even, 5-smooth, at least twice the width at 1e-12.
SPREAD_GRIDS = {1: (32,), 2: (32, 30), 3: (30, 32, 32)}
BACKENDS = ("auto", "xla")
# One point count for every case, so that the JAX package's eager ops
# compile once per shape for the module.
M = 100


def relerr(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def complex_normal(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def case(rank, m, transform_type, dtype, seed, batch=()):
    rng = np.random.default_rng(seed)
    grid = GRIDS[rank]
    pts = rng.uniform(-np.pi, np.pi, (m, rank)).astype(REAL[dtype])
    src = complex_normal(rng, batch + ((m,) if transform_type == "type_1"
                                       else grid), dtype)
    return grid, pts, src


def opts(backend, **kw):
    return tnt.Options(backend=backend, **kw)
