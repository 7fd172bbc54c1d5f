"""The port's complex type-3 transforms against the JAX package.

``ops.type3``'s statics are the JAX package's numpy code, copied: every
field equals the JAX package's (``assert_array_equal`` on the arrays) at
ranks 1-3, both directions, tolerances 1e-2 to 1e-12 and the degenerate,
far-offset and adversarial point sets of ``tests/test_type3.py``.
``tnt.Type3Plan`` on CPU tensors (both CPU routes: the plain versions and
the torch-op XLA path that complex128 takes on the card) against
``tfft.Type3Plan`` (its XLA path) on the same seeded inputs: within 1e-5
of the peak for complex64 and 1e-10 for complex128; the strengths'
gradient is the conjugate of ``jax.grad``'s (PyTorch's convention); the
error messages are the JAX package's. The planar twin is in
``tests/test_torch_type3_planar.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.ops import type3 as jtype3
from tensorflow_nufft_tpu_torch.ops import type3 as ttype3
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = {np.complex64: 1e-5, np.complex128: 1e-10}
TOL = {np.complex64: 1e-6, np.complex128: 1e-12}
REAL = {np.complex64: np.float32, np.complex128: np.float64}


def relerr(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().resolve_conj().numpy()
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def sets(rank, m=300, k=250, seed=3, dtype=np.float64,
         x_span=(-3.0, 7.0), t_span=(-20.0, 50.0)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(*x_span, (m, rank)).astype(dtype),
            rng.uniform(*t_span, (k, rank)).astype(dtype))


def strengths(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _special_sets():
    rng = np.random.default_rng(9)
    return {
        "x_zero_extent": (np.tile([[0.7, -1.3]], (25, 1)),
                          rng.uniform(-5, 5, (40, 2))),
        "t_zero_extent": (rng.uniform(-5, 5, (25, 2)),
                          np.tile([[2.0, 3.5]], (40, 1))),
        "far_offset": (rng.uniform(1000.0, 1010.0, (200, 1)),
                       rng.uniform(-500.0, -480.0, (150, 1))),
        "outlier": (np.concatenate([rng.uniform(-1, 1, (150, 2)),
                                    [[90.0, -75.0]]]),
                    rng.uniform(-3, 3, (100, 2))),
        "log_spaced": (rng.uniform(-2, 2, (120, 2)),
                       np.stack([np.logspace(-2, 1.5, 80),
                                 np.logspace(-1, 1.2, 80)], axis=-1)),
        "degenerate_x_wide_t": (np.zeros((100, 1)),
                                rng.uniform(-4000.0, 4000.0, (50, 1))),
        "both_zero_extent": (np.zeros((10, 3)), np.ones((12, 3))),
    }


SPECIAL = _special_sets()


def assert_statics_equal(x, t, direction, tol, real_dt):
    want = jtype3.compute_type3_statics(x, t, direction, tol, real_dt)
    got = ttype3.compute_type3_statics(x, t, direction, tol, real_dt)
    for field in ("rank", "num_points", "num_targets", "fine_shape",
                  "width", "beta"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("xi", "theta", "prephase", "postphase"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("real_dt", [np.float32, np.float64])
@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6, 1e-9, 1e-12])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_statics_equal_jax(rank, direction, tol, real_dt):
    x, t = sets(rank, 60, 50, seed=rank)
    assert_statics_equal(x, t, direction, tol, real_dt)


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_statics_equal_jax_special_sets(name):
    x, t = SPECIAL[name]
    for direction in ("forward", "backward"):
        assert_statics_equal(np.asarray(x, np.float64),
                             np.asarray(t, np.float64), direction, 1e-9,
                             np.float64)


def test_statics_too_big_message():
    x, t = sets(3, 10, 10, x_span=(-40.0, 40.0), t_span=(-40.0, 40.0))
    with pytest.raises(ValueError) as want:
        jtype3.compute_type3_statics(x, t, "forward", 1e-6)
    with pytest.raises(ValueError) as got:
        ttype3.compute_type3_statics(x, t, "forward", 1e-6)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,rank,want", [
    (270, 2, 288), (288, 2, 288), (72, 3, 72), (90, 3, 96)])
def test_next_tile_friendly_values(n, rank, want):
    assert ttype3._next_tile_friendly(n, rank) == want


def test_next_tile_friendly_matches_jax():
    for n in (17, 100, 255, 270, 513, 1000):
        for rank in (1, 2, 3):
            m = ttype3._next_tile_friendly(n, rank)
            assert m == jtype3._next_tile_friendly(n, rank)
            assert m >= n and m % (32 if rank <= 2 else 8) == 0


def test_kernel_ft_equals_jax():
    omega = np.linspace(-np.pi, np.pi, 101)
    for width in (2, 7, 13):
        beta = 2.3 * width
        np.testing.assert_array_equal(
            ttype3.kernel_ft(omega, width, beta),
            jtype3.kernel_ft(omega, width, beta))


@functools.lru_cache(maxsize=None)
def jax_plan_case(rank, dtype):
    """(x, t, c, the JAX plan's fine shape and output) of one case."""
    span = (-2.0, 2.0) if rank == 3 else (-20.0, 50.0)
    x, t = sets(rank, 300, 250, dtype=REAL[dtype], t_span=span)
    c = strengths((2, 300), dtype)
    plan = tfft.Type3Plan(x, t, tol=TOL[dtype])
    return x, t, c, plan.fine_shape, np.asarray(jax.jit(plan)(c))


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_type3_plan_matches_jax(rank, dtype, backend):
    x, t, c, fine_shape, want = jax_plan_case(rank, dtype)
    op = tnt.Type3Plan(x, t, tol=TOL[dtype],
                       options=tnt.Options(backend=backend), device="cpu")
    got = op(torch.from_numpy(c))
    assert got.dtype == torch.from_numpy(c).dtype
    assert op.fine_shape == fine_shape
    assert relerr(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_nufft_type3_matches_jax_and_oracle(direction):
    x, t = sets(2, 200, 150)
    c = strengths((200,), np.complex128)
    kw = dict(fft_direction=direction)
    want = np.asarray(jax.jit(lambda c: tfft.nufft_type3(
        c, x, t, tol=1e-9, **kw))(c))
    got = tnt.nufft_type3(c, x, t, tol=1e-9, device="cpu", **kw)
    assert got.shape == (150,)
    assert relerr(got, want) <= 1e-10
    oracle = tnt.nudft_type3(c, x, t, device="cpu", **kw)
    assert relerr(oracle, tfft.nudft_type3(c, x, t, **kw)) <= 1e-12
    assert relerr(got, oracle) <= 1e-8


def test_planar_nudft_type3_matches_jax():
    x, t = sets(3, 40, 30, dtype=np.float32)
    c = strengths((2, 40), np.complex64)
    cp = np.stack([c.real, c.imag], axis=-1)
    for direction in ("forward", "backward"):
        want = np.asarray(tfft.planar.nudft_type3(cp, x, t, direction))
        got = tnt.planar.nudft_type3(cp, x, t, direction, device="cpu")
        assert relerr(got, want) <= 1e-5


def test_strength_gradient_is_conjugate_of_jax():
    x, t = sets(2, 60, 50)
    c = strengths((60,), np.complex128)
    ct = strengths((50,), np.complex128, seed=6)
    plan = tfft.Type3Plan(x, t, tol=1e-9)
    want = jax.jit(jax.grad(lambda s: jnp.real(jnp.vdot(ct, plan(s)))))(c)
    src = torch.from_numpy(c).requires_grad_()
    out = tnt.Type3Plan(x, t, tol=1e-9, device="cpu")(src)
    (torch.from_numpy(ct).conj() * out).sum().real.backward()
    assert relerr(src.grad.conj(), want) <= 1e-10


def test_complex64_gradient_through_cores():
    """The complex64 backward (the interp transpose of the spread and the
    type-2 core's adjoint) gives the complex128 gradient, which
    ``test_strength_gradient_is_conjugate_of_jax`` holds to JAX's."""
    x, t = sets(1, 80, 60)
    c = strengths((80,), np.complex128)
    ct = torch.from_numpy(strengths((60,), np.complex128, seed=6))
    grads = []
    for dtype in (np.complex64, np.complex128):
        src = torch.from_numpy(c.astype(dtype)).requires_grad_()
        out = tnt.Type3Plan(x.astype(REAL[dtype]), t.astype(REAL[dtype]),
                            device="cpu")(src)
        (ct.to(out.dtype).conj() * out).sum().real.backward()
        grads.append(src.grad)
    assert relerr(grads[0].to(torch.complex128), grads[1]) <= 1e-5


def test_max_batch_size_chunking():
    x, t = sets(1, 80, 60)
    c = torch.from_numpy(strengths((5, 80), np.complex128))
    got = tnt.nufft_type3(c, x, t, tol=1e-9,
                          options=tnt.Options(max_batch_size=2))
    ref = tnt.nufft_type3(c, x, t, tol=1e-9)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert got.shape == (5, 60)


def _messages():
    x, t = sets(2, 20, 10)
    x32, t32 = x.astype(np.float32), t.astype(np.float32)
    c = strengths((20,), np.complex128)
    c64 = strengths((20,), np.complex64)
    # Each case takes the package and its array converter (CPU tensors for
    # the port, whose entry points put numpy input on the card).
    return {
        "points_ndim": lambda m, a: m.Type3Plan(a(x[None]), a(t)),
        "rank_mismatch": lambda m, a: m.Type3Plan(a(x), a(t[:, :1])),
        "rank_4": lambda m, a: m.Type3Plan(a(np.zeros((5, 4))),
                                           a(np.zeros((5, 4)))),
        "empty": lambda m, a: m.Type3Plan(a(np.zeros((0, 2))), a(t)),
        "dtype_mismatch": lambda m, a: m.Type3Plan(a(x32), a(t)),
        "int_points": lambda m, a: m.Type3Plan(a(x.astype(np.int32)),
                                               a(t.astype(np.int32))),
        "upsampling": lambda m, a: m.Type3Plan(
            a(x), a(t), options=m.Options(upsampling_factor=1.25)),
        "direction": lambda m, a: m.Type3Plan(a(x), a(t),
                                              fft_direction="up"),
        "source_dtype": lambda m, a: m.Type3Plan(a(x), a(t))(a(c64)),
        "source_shape": lambda m, a: m.Type3Plan(a(x), a(t))(a(c[:5])),
        "nudft_direction": lambda m, a: m.nudft_type3(a(c), a(x), a(t),
                                                      "up"),
        "planar_float64": lambda m, a: m.planar.Type3Plan(a(x), a(t)),
        "planar_source_dtype": lambda m, a: m.planar.Type3Plan(
            a(x32), a(t32))(a(np.zeros((1, 20, 2)))),
        "planar_source_shape": lambda m, a: m.planar.Type3Plan(
            a(x32), a(t32))(a(np.zeros((1, 19, 2), np.float32))),
        "planar_direction": lambda m, a: m.planar.Type3Plan(
            a(x32), a(t32), "up"),
    }


MESSAGES = _messages()


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_error_messages_are_jax(name):
    fn = MESSAGES[name]
    with pytest.raises(Exception) as want:
        fn(tfft, np.asarray)
    with pytest.raises(Exception) as got:
        fn(tnt, torch.from_numpy)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_points_that_require_grad_raise():
    x, t = sets(2, 20, 10)
    with pytest.raises(ValueError, match="must be concrete"):
        tnt.Type3Plan(torch.from_numpy(x).requires_grad_(),
                      torch.from_numpy(t))
    with pytest.raises(ValueError, match="target_points must be concrete"):
        tnt.planar.Type3Plan(torch.from_numpy(x).float(),
                             torch.from_numpy(t).float().requires_grad_())


@pytest.mark.parametrize("api", ["complex", "planar"])
def test_type_3_redirect(api):
    mod_j, mod_t = ((tfft, tnt) if api == "complex"
                    else (tfft.planar, tnt.planar))
    x = np.zeros((4, 2), np.float32)
    src = (np.zeros(4, np.complex64) if api == "complex"
           else np.zeros((4, 2), np.float32))
    with pytest.raises(NotImplementedError) as want:
        mod_j.nufft(src, x, transform_type="type_3")
    with pytest.raises(NotImplementedError) as got:
        mod_t.nufft(torch.from_numpy(src), torch.from_numpy(x),
                    transform_type="type_3")
    assert str(got.value) == str(want.value).replace(
        "tensorflow_nufft_tpu.", "tensorflow_nufft_tpu_torch.")
