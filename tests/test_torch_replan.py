"""The port's band re-plan rule against the JAX package's.

A rank-3 binned plan keeps its coarse axis-0 geometry only where the JAX
package's memory model (``pallas_spread.streaming_group_size``) accepts
the band; otherwise the JAX plan re-plans on the unbanded geometry
(``PlannedNufft._ensure_viable``), or runs unplanned where that geometry
is rejected too. The port keeps the same rule (``binning.
streaming_group_size``), so both packages take the same level, geometry,
slot count and slot mask. With the budgets lowered (the dense-matrix
budget to 0, the memory budget as below), a small 3D size reaches the
three outcomes: a band that stays, a band narrower than E0 that is
rejected, and a plan that ends unplanned. Plans only, no transforms.
"""

import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu import planar as jplanar
from tensorflow_nufft_tpu.kernels import pallas_spread
from tensorflow_nufft_tpu.options import Options
from tensorflow_nufft_tpu_torch import PlannedNufft
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tests.torch_threads import one_torch_thread  # noqa: F401

# Fine grid (64, 32, 32): the banded geometry has ext (72, 24, 40), the
# unbanded one (24, 24, 40). A channel pair needs 3.62e6 B of the model
# with the uniform points' band (16 rows), 4.05e6 B with the clustered
# points' (20 rows) and 3.29e6 B on the unbanded geometry.
GRID = (32, 16, 16)
M = 3000


def _points(clustered):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-np.pi, np.pi, (M, 3))
    if clustered:
        # Two axis-0 clusters: a wider band, still narrower than E0.
        pts[:, 0] = (np.where(rng.random(M) < 0.5, 0.0, 2.0)
                     + 0.3 * rng.standard_normal(M))
    return pts.astype(np.float32)


def _geom(g):
    return (g.fine_shape, g.tile, g.pad, g.chunk, g.num_chunks)


@pytest.mark.parametrize("clustered,budget,level,band", [
    (False, 3_800_000, "binned", 16),   # the band stays
    (True, 3_800_000, "binned", None),  # rejected: the unbanded geometry
    (True, 3_000_000, "none", None),    # both rejected: unplanned
])
def test_replan_matches_jax(monkeypatch, clustered, budget, level, band):
    monkeypatch.setattr(pallas_spread, "MATS_BYTES_BUDGET", 0)
    monkeypatch.setattr(pallas_spread, "VMEM_RESIDENT_BUDGET", budget)
    monkeypatch.setattr(tb, "MATS_BYTES_BUDGET", 0)
    monkeypatch.setattr(tb, "VMEM_RESIDENT_BUDGET", budget)
    pts = _points(clustered)
    jop = jplanar.PlannedNufft(pts, GRID, transform_type="type_1",
                               tol=1e-6, options=Options(backend="pallas"))
    top = PlannedNufft(pts, GRID, transform_type="type_1", device="cpu")
    assert (jop._level if jop._planned else "none") == top.level == level
    assert top.num_slots == jop.num_slots
    if level == "none":
        # The JAX plan keeps the mask of its first geometry here; the
        # slot axis is the point axis (num_slots == M).
        assert top.num_slots == M
        np.testing.assert_array_equal(top.slot_mask.numpy(), np.ones(M))
        return
    assert _geom(top.geom) == _geom(jop.geom)
    banded = tb.choose_geometry(top.plan.fine_shape, top.plan.width, M,
                                banded=True)
    assert (top.geom == banded) == (band is not None)
    if band is not None:
        assert top.band_info.band == jop.band_info[0] == band
    else:
        # The band on the banded geometry was narrower than E0, and the
        # model rejected it all the same.
        _, binned = bin_for_plan(torch.from_numpy(pts), top.plan, banded,
                                 zorder=True)
        wide, _ = tb.compute_band_origins(binned, banded,
                                          top.plan.half_width)
        assert wide < banded.ext[0]
        assert tb.streaming_group_size(banded, wide) == 0
    np.testing.assert_array_equal(top.slot_mask.numpy(),
                                  np.asarray(jop.slot_mask))
    for name in ("padpos", "invpos", "tile_bounds"):
        np.testing.assert_array_equal(getattr(top.binned, name).numpy(),
                                      np.asarray(getattr(jop.binned, name)))
