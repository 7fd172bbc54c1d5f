"""The work counts of ``roofline.py``: by hand, which bound binds, and
independent of the program's tiles and plan level."""

import math

import pytest

from benchmark import roofline


def test_hand_counted_spread():
    # 10 points in 2D on 4x4 modes (fine 8x8 = 64 cells), re and im,
    # tol 1e-2 (width 3, 9 window cells).
    stage = roofline.Stage("spread", 10, (4, 4), 2, 1e-2)
    nbytes, ops = stage.work()
    assert nbytes == 4 * (2 * 64 + 10 * (2 + 2))
    assert ops == 10 * 9 * (2 * 2 + 1)


def test_width_and_fine_grid():
    assert roofline.kernel_width(1e-6) == 7
    assert roofline.kernel_width(1e-2) == 3
    assert roofline.fine_shape((128, 128, 128)) == (256, 256, 256)
    assert roofline.fine_shape((7,)) == (15,)
    assert roofline.smooth_up(97) == 100


@pytest.mark.parametrize("stages,binds", [
    ([roofline.Stage("spread", 800_000, (128,) * 3, 2, 1e-6)], "bytes"),
    ([roofline.Stage("interp", 10 ** 6, (4, 4, 4), 2, 1e-6)],
     "operations"),
])
def test_binding_bound_is_named(stages, binds):
    seconds, got = roofline.least_time(stages)
    nbytes, ops = stages[0].work()
    assert got == binds
    assert seconds == pytest.approx(max(
        nbytes / roofline.PEAK_BYTES_PER_S, ops / roofline.PEAK_F32_PER_S))


def test_work_adds_over_stages():
    one = roofline.Stage("interp", 1000, (16, 16), 4, 1e-6)
    single, _ = roofline.least_time([one])
    triple, _ = roofline.least_time([one] * 3)
    assert triple == pytest.approx(3 * single)


def test_count_is_the_same_under_two_plan_levels(monkeypatch):
    """The same problem planned at the "mats" and at the "binned" level
    (other tiles, payloads and slots) counts the same work."""
    from benchmark import run
    from tensorflow_nufft_tpu_torch.kernels import binning
    config = {"modes": [32, 32], "points": {"kind": "uniform",
                                            "count": 2000}, "tol": 1e-6}
    traffic = {"entry": "planned", "transform_type": "type_1",
               "fft_direction": "backward", "batch": 2, "pool": 1,
               "kept": 1, "check_size": 8}
    mats, _ = run.build_cell("3d_128_800k_t1", 5, "cpu", config, traffic)
    monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
    binned, _ = run.build_cell("3d_128_800k_t1", 5, "cpu", config, traffic)
    assert (mats.op.level, binned.op.level) == ("mats", "binned")
    assert mats.stages == binned.stages
    assert (roofline.least_time(mats.stages["spread"])
            == roofline.least_time(binned.stages["spread"]))
    assert mats.stages["spread"][0].work()[0] == 4 * (
        4 * math.prod(roofline.fine_shape((32, 32))) + 2000 * (2 + 4))
