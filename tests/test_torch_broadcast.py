"""Broadcasting of the port's complex API, its ``Options`` and its route
rule, against the JAX package."""

import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tests.torch_complex_cases import RTOL, complex_normal, opts, relerr
from tests.torch_threads import one_torch_thread  # noqa: F401
from tensorflow_nufft_tpu_torch.kernels import dispatch
from tensorflow_nufft_tpu_torch.plan import plan as tplan


# (source batch, points batch), as tests/test_nufft.py.
BATCH_COMBOS = [((), ()), ((2,), ()), ((), (2,)), ((2,), (2,)),
                ((3, 2), (2,)), ((3, 1), (3, 2))]


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("src_batch,pts_batch", BATCH_COMBOS)
def test_broadcasting_matches_jax(src_batch, pts_batch, transform_type):
    rng = np.random.default_rng(3)
    grid, m = (6, 8), 14
    pts = rng.uniform(-np.pi, np.pi, pts_batch + (m, 2)).astype(np.float32)
    src = complex_normal(rng, src_batch + ((m,) if transform_type == "type_1"
                                     else grid), np.complex64)
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type)
    want = np.asarray(tfft.nufft(src, pts, **kw))
    got = tnt.nufft(src, pts, device="cpu", **kw)
    assert relerr(got, want) <= RTOL[np.complex64]
    oracle = np.asarray(tfft.nudft(src, pts, **kw))
    assert relerr(tnt.nudft(src, pts, device="cpu", **kw), oracle) <= 1e-5


class TestOptions:
    """The port's Options against the JAX package's pydantic model."""

    def test_defaults_and_fields(self):
        ours, ref = tnt.Options(), tfft.Options()
        assert list(vars(ours)) == list(type(ref).model_fields)
        for name in type(ref).model_fields:
            if name in ("debugging", "fftw"):
                continue
            assert getattr(ours, name) == getattr(ref, name), name
        assert ours.debugging.check_points_range is False
        assert ours.fftw.planning_rigor == tnt.FftwPlanningRigor.AUTO

    @pytest.mark.parametrize("cls", ["PointsRange", "FftwPlanningRigor"])
    def test_enums_equal_jax(self, cls):
        ours, ref = getattr(tnt, cls), getattr(tfft, cls)
        assert [(m.name, int(m)) for m in ours] == \
            [(m.name, int(m)) for m in ref]

    @pytest.mark.parametrize("kw", [
        dict(max_batch_size=0), dict(max_batch_size=-3),
        dict(backend="cuda"), dict(upsampling_factor=0.9),
        dict(upsampling_factor=1.0), dict(verbosity=-1),
        dict(kernel_evaluation_method="exact"), dict(points_range=7)])
    def test_validation_errors_match_jax(self, kw):
        with pytest.raises(ValueError) as ref:
            tfft.Options(**kw)
        with pytest.raises(ValueError) as port:
            tnt.Options(**kw)
        if "points_range" not in kw:
            assert str(port.value) in str(ref.value)

    @pytest.mark.parametrize("name,bad,good", [
        ("max_batch_size", -1, 8), ("backend", "tpu", "xla"),
        ("verbosity", -2, 1), ("upsampling_factor", 0.5, 1.5)])
    def test_assignment_validation(self, name, bad, good):
        for opts in (tnt.Options(), tfft.Options()):
            with pytest.raises(ValueError):
                setattr(opts, name, bad)
            setattr(opts, name, good)
            assert getattr(opts, name) == good
        debug = tnt.DebuggingOptions()
        with pytest.raises(ValueError):
            debug.check_points_range = "yes"
        fftw = tnt.FftwOptions()
        fftw.planning_rigor = 2
        assert fftw.planning_rigor == tnt.FftwPlanningRigor.MEASURE


class TestRoute:
    """``dispatch.route`` and the backend option's outcomes."""

    @staticmethod
    def _spec(dtype_name, backend="auto"):
        return tplan.PlanSpec("type_2", "forward", 2, (16, 16), dtype_name,
                              1e-6, 1, backend=backend)

    @pytest.mark.parametrize("dtype_name,backend,device,want", [
        ("complex64", "auto", "cuda", "kernels"),
        ("complex128", "auto", "cuda", "xla"),
        ("complex64", "auto", "cpu", "plain"),
        ("complex128", "auto", "cpu", "plain"),
        ("complex64", "xla", "cuda", "xla"),
        ("complex64", "xla", "cpu", "xla"),
        ("complex64", "pallas", "cuda", "kernels"),
        ("complex64", "pallas", "cpu", "plain"),
        ("complex64", "native", "cuda", "native"),
        ("complex128", "native", "cpu", "native")])
    def test_route(self, dtype_name, backend, device, want):
        assert dispatch.route(self._spec(dtype_name, backend),
                              device) == want

    def test_pallas_float64_raises_jax_message(self):
        pts = np.zeros((4, 2))
        src = np.zeros((4, 2))
        kw = dict(grid_shape=(16, 16), transform_type="type_1")
        with pytest.raises(ValueError) as ref:
            tfft.planar.nufft(src, pts, options=tfft.Options(
                backend="pallas"), **kw)
        with pytest.raises(ValueError) as port:
            tnt.planar.nufft(src, pts, options=tnt.Options(
                backend="pallas"), device="cpu", **kw)
        assert str(port.value) == str(ref.value)
        with pytest.raises(ValueError, match="backend='pallas'"):
            tnt.PlannedNufft(pts, (16, 16), options=tnt.Options(
                backend="pallas"), device="cpu")

    def test_native_not_ported(self):
        """The name predates the port of the native engine: backend=
        'native' now runs the host engine, as the JAX package's eager
        native API does."""
        from tensorflow_nufft_tpu import native
        rng = np.random.default_rng(0)
        z = (rng.standard_normal((16, 16))
             + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
        pts = rng.uniform(-np.pi, np.pi, (4, 2)).astype(np.float32)
        got = tnt.nufft(z, pts, device="cpu",
                        options=tnt.Options(backend="native"))
        want = native.nufft(z, pts)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_xla_plans_take_level_none(self):
        pts = np.random.default_rng(0).uniform(-np.pi, np.pi, (50, 2))
        op = tnt.PlannedNufft(pts.astype(np.float32), (16, 16), device="cpu",
                              options=tnt.Options(backend="xla"))
        assert op.level == "none"
        assert tnt.PlannedNufft(pts.astype(np.float32), (16, 16),
                                device="cpu").level != "none"

    def test_type3_message(self):
        with pytest.raises(NotImplementedError, match="different signature"):
            tnt.nufft(np.zeros((16, 16), np.complex64),
                      np.zeros((4, 2), np.float32), device="cpu",
                      transform_type="type_3")

    @pytest.mark.parametrize("kw,err", [
        (dict(source=np.zeros(4, np.float32)), TypeError),
        (dict(points=np.zeros((4, 2), np.float64)), TypeError),
        (dict(grid_shape=None), ValueError),
        (dict(grid_shape=(16,)), ValueError),
        (dict(points=np.zeros((5, 2), np.float32)), ValueError)])
    def test_argument_errors_match_jax(self, kw, err):
        args = dict(source=np.zeros(4, np.complex64),
                    points=np.zeros((4, 2), np.float32),
                    grid_shape=(16, 16))
        args.update(kw)
        with pytest.raises(err):
            tfft.nufft(transform_type="type_1", **args)
        with pytest.raises(err):
            tnt.nufft(transform_type="type_1", device="cpu", **args)


