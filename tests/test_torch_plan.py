"""The port's plan math and tile geometry equal the JAX package's.

Both are numpy only, so this sweeps widely and costs little.
"""

import itertools

import numpy as np
import pytest

from tensorflow_nufft_tpu.kernels import binning as jbinning
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning as tbinning
from tensorflow_nufft_tpu_torch.options.options import Options, PointsRange
from tensorflow_nufft_tpu_torch.plan import plan as tplan

_SPECS = [
    (rank, tol, dtype, sigma, kev)
    for rank, tol, dtype, sigma, kev in itertools.product(
        (1, 2, 3), (1e-2, 1e-3, 1e-6, 1e-9, 1e-14),
        ("complex64", "complex128"), (None, 1.25, 2.0),
        ("auto", "direct", "horner"))
    if not (kev == "horner" and dtype == "complex128")
]


def _grid(rank):
    return {1: (200,), 2: (64, 96), 3: (16, 24, 20)}[rank]


def _specs(rank, tol, dtype, sigma, kev):
    kw = dict(transform_type="type_1", fft_direction="forward", rank=rank,
              grid_shape=_grid(rank), dtype_name=dtype, tol=tol,
              points_range=1, upsampling_factor=sigma,
              kernel_evaluation_method=kev)
    return jplan.PlanSpec(**kw), tplan.PlanSpec(**kw)


@pytest.mark.parametrize("rank", (1, 2, 3))
def test_plan_fields_equal_jax(rank):
    for spec_args in (s for s in _SPECS if s[0] == rank):
        js, ts = _specs(*spec_args)
        jp, tp = jplan.make_plan(js), tplan.make_plan(ts)
        for field in ("sigma", "width", "beta", "c", "half_width",
                      "fine_shape", "kernel_scale", "tol", "horner"):
            assert getattr(tp, field) == getattr(jp, field), (spec_args,
                                                             field)
        for d in range(rank):
            np.testing.assert_array_equal(tp.fseries[d], jp.fseries[d])
            np.testing.assert_array_equal(tp.deconv_weights(d),
                                          jp.deconv_weights(d))
        assert tplan.auto_max_batch_size(ts, 2) == \
            jplan.auto_max_batch_size(js, 2)


def test_spec_fields_match_jax_except_backend():
    """The port's PlanSpec has every field of the JAX one, in its order
    (``backend`` too, since the port has its routes)."""
    jfields = list(jplan.PlanSpec.__dataclass_fields__)
    tfields = list(tplan.PlanSpec.__dataclass_fields__)
    assert tfields == jfields


@pytest.mark.parametrize("fine_shape,width,num_points", [
    ((128, 128), 7, 2000), ((128, 192), 7, 2000), ((128, 192), 4, 2000),
    ((512, 512), 7, 65536), ((512, 512), 4, 65536), ((320, 160), 7, 500),
    ((24, 24), 7, 100), ((400,), 7, 5000), ((4096,), 10, 10 ** 6),
    ((32, 48, 40), 7, 700), ((256, 256, 256), 7, 800_000),
])
def test_choose_geometry_equals_jax(fine_shape, width, num_points):
    jg = jbinning.choose_geometry(fine_shape, width, num_points)
    tg = tbinning.choose_geometry(fine_shape, width, num_points)
    assert (tg.fine_shape, tg.tile, tg.pad, tg.chunk, tg.num_chunks) == \
        (jg.fine_shape, jg.tile, jg.pad, jg.chunk, jg.num_chunks)
    assert (tg.tiles, tg.ext, tg.num_tiles) == \
        (jg.tiles, jg.ext, jg.num_tiles)
    assert tbinning.geometry_valid(tg) == jbinning.geometry_valid(jg)


def test_check_fine_grid_size_and_warning():
    _, ts = _specs(2, 1e-6, "complex64", None, "auto")
    plan = tplan.make_plan(ts)
    tplan.check_fine_grid_size(plan, 2)
    with pytest.raises(ValueError, match="Fine grid is too big"):
        tplan.check_fine_grid_size(plan, 10 ** 6)
    with pytest.warns(RuntimeWarning, match="clamped"):
        tplan.warn_if_tol_clamped(1e-9, "complex64", True)


def test_options_validate():
    assert Options().points_range == PointsRange.EXTENDED
    assert Options(points_range=2).points_range == PointsRange.INFINITE
    for bad in (dict(upsampling_factor=1.0), dict(max_batch_size=0),
                dict(kernel_evaluation_method="exact"),
                dict(verbosity=-1)):
        with pytest.raises(ValueError):
            Options(**bad)
