"""The float32 floors of the port's CPU path and of the JAX package's
float32 path, on the same inputs (ROADMAP fault 5).

Each case draws float32 inputs from a seed with numpy and runs them
through the JAX package's float32 path (``backend`` auto, its XLA path
on the CPU) and the port's CPU path (the plain versions of its kernels).
Each side's error is measured against one float64 reference: the JAX
float64 transform of the same (float32-rounded) inputs, and the exact
NUDFT on a seeded 1024-element subset of the outputs, both relative to
the peak of the float64 transform. ``tests/test_torch_float32_floor.py``
runs the small sizes; this module's main runs the headline sizes:

    JAX_PLATFORMS=cpu python -m tests.torch_float32_floor [--small]

(the 1D type-2 at 2^20 modes and 10^7 points, about 2 minutes and 5 GB
on an 8-core CPU; type-3 at bench_suite.py's 2d_t3_200k_200k size).
"""

import argparse

import jax
import numpy as np
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt

TOL = 1e-6
SUBSET = 1024
# (modes, points) of the 1D type-2; M = K of the 2D type-3 (t_range 64).
SIZES = {"small": {"type2_1d": (2 ** 14, 100_000), "type3_2d": (20_000,)},
         "headline": {"type2_1d": (2 ** 20, 10_000_000),
                      "type3_2d": (200_000,)}}


def _errors(got, ref, exact, sub):
    """(vs the float64 transform, vs the exact NUDFT at ``sub``), relative
    to the peak of the float64 transform."""
    got = np.asarray(got).astype(np.complex128)
    scale = np.abs(ref).max()
    return (float(np.abs(got - ref).max() / scale),
            float(np.abs(got[sub] - exact).max() / scale))


def type2_1d(n, m, seed=5):
    """1D type-2, n modes at m uniform points. Returns (port errors, JAX
    errors)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-np.pi, np.pi, (m, 1)).astype(np.float32)
    f = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    run = jax.jit(lambda f, x: tfft.nufft(f, x, tol=TOL))
    ref = np.asarray(run(f.astype(np.complex128), x.astype(np.float64)))
    assert ref.dtype == np.complex128
    sub = np.sort(np.random.default_rng(seed + 1).choice(m, SUBSET,
                                                         replace=False))
    k = np.arange(n) - n // 2
    xs, f64 = x[sub].astype(np.float64), f.astype(np.complex128)
    exact = np.zeros(SUBSET, np.complex128)
    for lo in range(0, n, 1 << 14):
        exact += np.exp(-1j * xs * k[None, lo:lo + (1 << 14)]) @ f64[
            lo:lo + (1 << 14)]
    jax_err = _errors(run(f, x), ref, exact, sub)
    port_err = _errors(tnt.nufft(torch.from_numpy(f), torch.from_numpy(x),
                                 tol=TOL).numpy(), ref, exact, sub)
    return port_err, jax_err


def type3_2d(m, seed=7):
    """Planar 2D type-3, M = K = m, points in [-pi, pi), targets in
    [-64, 64). Returns (port errors, JAX errors)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    t = rng.uniform(-64.0, 64.0, (m, 2)).astype(np.float32)
    c = (rng.standard_normal(m)
         + 1j * rng.standard_normal(m)).astype(np.complex64)
    x64, t64, c64 = x.astype(np.float64), t.astype(np.float64), c.astype(
        np.complex128)
    ref = np.asarray(jax.jit(tfft.Type3Plan(x64, t64, tol=TOL))(c64))
    assert ref.dtype == np.complex128
    sub = np.sort(np.random.default_rng(seed + 1).choice(m, SUBSET,
                                                         replace=False))
    exact = np.zeros(SUBSET, np.complex128)
    for lo in range(0, m, 1 << 15):
        exact += np.exp(-1j * (t64[sub] @ x64[lo:lo + (1 << 15)].T)) @ c64[
            lo:lo + (1 << 15)]
    planar = np.stack([c.real, c.imag], axis=-1)[None]
    got = np.asarray(tfft.planar.Type3Plan(x, t, tol=TOL)(planar))[0]
    jax_err = _errors(got[..., 0] + 1j * got[..., 1], ref, exact, sub)
    op = tnt.planar.Type3Plan(torch.from_numpy(x), torch.from_numpy(t),
                              tol=TOL, device="cpu")
    got = op(torch.from_numpy(planar))[0].numpy()
    port_err = _errors(got[..., 0] + 1j * got[..., 1], ref, exact, sub)
    return port_err, jax_err


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--small", action="store_true",
                        help="the test's sizes instead of the headline's")
    size = "small" if parser.parse_args().small else "headline"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)   # the float64 references
    for name, fn in (("type2_1d", type2_1d), ("type3_2d", type3_2d)):
        shape = SIZES[size][name]
        port, jax_ = fn(*shape)
        print(f"{name} {shape}: error vs the float64 transform / vs the "
              f"exact NUDFT ({SUBSET} outputs): port {port[0]:.4e} / "
              f"{port[1]:.4e}, JAX {jax_[0]:.4e} / {jax_[1]:.4e}; port / "
              f"JAX {port[0] / jax_[0]:.3f} / {port[1] / jax_[1]:.3f}",
              flush=True)


if __name__ == "__main__":
    main()
