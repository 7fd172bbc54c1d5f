"""What decides ``correct``, shown to fail: each cell's control (the
reference in TF32, in the program's place) and the faults a cell can
have, planted in the timed path of a whole run on the CPU, at a size a
test run holds. The unbroken run of each cell is correct."""

import pytest
import torch

from benchmark import run, spec

from .conftest import small_run

CELLS = ("3d_128_800k_t1", "3d_128_800k_t2", "3d_128_800k_train",
         "rrsg_brain_cgsense")


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(cell):
    result, checks = small_run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(checks) == set(spec.limits(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    from .conftest import SMALL
    bench = spec.load()
    w = spec.workload(bench, cell)
    traffic = dict(spec.traffic(w["traffic"]), check_size=64)
    built, traffic = run.build_cell(cell, 2147483652, "cpu",
                                    SMALL[w["config"]], traffic)
    built.release()
    limits = spec.limits(cell)
    failed = set()
    for p, entries in built.control(traffic["kept"]):
        failed |= {k for k, v in built.judge(p, entries).items()
                   if not v <= limits[k]}
    assert failed


def _alter(out):
    """An answer altered where it is produced: scaled by 1 + 1e-3."""
    if isinstance(out, torch.Tensor):
        return out * (1 + 1e-3)
    values, loss, gx, gk = out
    return values * (1 + 1e-3), loss, gx, gk


def _patched_call(monkeypatch, cell, wrap):
    from benchmark.entries import cgsense, planned, train
    kind = {"3d_128_800k_t1": planned.Planned,
            "3d_128_800k_t2": planned.Planned,
            "3d_128_800k_train": train.Train,
            "rrsg_brain_cgsense": cgsense.CgSense}[cell]
    call = kind.call
    monkeypatch.setattr(kind, "call", lambda self, i: wrap(call(self, i)))


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(monkeypatch, cell):
    _patched_call(monkeypatch, cell, _alter)
    result, _ = small_run(cell)
    assert not result["correct"] and result["failed"] > 0


def test_step_that_leaves_the_gradients_unchanged_is_not_correct(
        monkeypatch):
    """The training step returns the gradients it started from (zero):
    the backward pass left out."""
    _patched_call(monkeypatch, "3d_128_800k_train",
                  lambda out: (out[0], out[1], torch.zeros_like(out[2]),
                               torch.zeros_like(out[3])))
    result, checks = small_run("3d_128_800k_train")
    assert not result["correct"]
    assert checks["xgrad_err"][0] > checks["xgrad_err"][1]


def test_half_the_coils_left_out_is_not_correct(monkeypatch):
    """The SENSE operator's coil batch halved, the sum over the rest
    doubled to keep the scale."""
    from tensorflow_nufft_tpu_torch.models import mri
    normal = mri.SenseNufft.normal

    def half(self, image):
        maps = self.maps
        keep = maps.shape[0] // 2
        self.maps = maps[:keep]
        try:
            return normal(self, image) * (maps.shape[0] / keep)
        finally:
            self.maps = maps
    monkeypatch.setattr(mri.SenseNufft, "normal", half)
    result, _ = small_run("rrsg_brain_cgsense")
    assert not result["correct"]
