"""The port's XLA-path ops (``kernels.xla_ops``) against the JAX
package's ``spread_geometry``, ``spread_xla`` and ``interp_xla``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.kernels import xla_ops as jxla
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import torch_ops, xla_ops
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_complex_cases import M, SPREAD_GRIDS, complex_normal, relerr
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("deriv_axis", [None, "last"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_xla_ops_match_jax(rank, deriv_axis, dtype):
    """spread_geometry (indices equal, kernels within the dtype's
    rounding), spread_xla and interp_xla against the JAX package's."""
    if deriv_axis == "last":
        deriv_axis = rank - 1
    fine = SPREAD_GRIDS[rank]
    kw = dict(transform_type="type_1", fft_direction="forward", rank=rank,
              grid_shape=fine, tol=1e-6, points_range=1, spread_only=True,
              dtype_name="complex64" if dtype == np.float32
              else "complex128")
    jp, tp = jplan.make_plan(jplan.PlanSpec(**kw)), tplan.make_plan(
        tplan.PlanSpec(**kw))
    rng = np.random.default_rng(rank)
    pts = rng.uniform(-np.pi, np.pi, (M, rank)).astype(dtype)
    jres = jxla.fold_and_rescale_split(jnp.asarray(pts), fine, 1)
    tres = torch_ops.fold_and_rescale_split(torch.from_numpy(pts), fine, 1)
    jidx, jker = jxla.spread_geometry(jres, jp, deriv_axis=deriv_axis)
    tidx, tker = xla_ops.spread_geometry(tres, tp, deriv_axis=deriv_axis)
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    for d in range(rank):
        np.testing.assert_array_equal(tidx[d].numpy(), np.asarray(jidx[d]))
        assert relerr(tker[d], np.asarray(jker[d])) <= rtol
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    vals = complex_normal(rng, (2, M), cdt)
    grid = complex_normal(rng, (2,) + fine, cdt)
    want = jxla.spread_xla(jnp.asarray(vals), jidx, jker, jp)
    got = xla_ops.spread_xla(torch.from_numpy(vals), tidx, tker, tp)
    assert relerr(got, np.asarray(want)) <= rtol
    want = jxla.interp_xla(jnp.asarray(grid), jidx, jker, jp)
    got = xla_ops.interp_xla(torch.from_numpy(grid), tidx, tker, tp)
    assert relerr(got, np.asarray(want)) <= rtol
    real = vals.real.astype(dtype)
    want = jxla.spread_xla(jnp.asarray(real), jidx, jker, jp)
    got = xla_ops.spread_xla(torch.from_numpy(real), tidx, tker, tp)
    assert got.dtype == torch.from_numpy(real).dtype
    assert relerr(got, np.asarray(want)) <= rtol
