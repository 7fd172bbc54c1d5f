"""The port's layer spans (``utils.profiling.scope``) on small CPU inputs
under ``torch.profiler``: ``PlannedNufft``'s ``plan.*`` spans around its
stage spans, the MRI models' ``mri.*`` and ``cg.iter`` and the
binning's ``prep.bin``; and, with no profiler active, none of these
paths opens a ``record_function``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensorflow_nufft_tpu_torch import planar
from tensorflow_nufft_tpu_torch.fft import planar_fft
from tensorflow_nufft_tpu_torch.kernels import binning
from tensorflow_nufft_tpu_torch.models import mri
from tests.torch_threads import one_torch_thread  # noqa: F401

GRIDS = {2: (16, 16), 3: (8, 8, 8)}
M = 64

T2 = ["nufft.amplify_dft", "nufft.interp"]
T1 = ["nufft.spread", "nufft.mode_dft_deconvolve"]


def _points(rank, m=M, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32))


def _randn(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(1))


def _spans(fn):
    """The program spans a call of ``fn`` records, by start: (name,
    start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.is_user_annotation]
    return sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _planned_calls(op):
    """Each planned apply of a type-2 plan ``op`` and the spans it opens,
    in order: its ``plan.*`` span, then the stages inside it. A lone
    type-2 apply and the point-order gathers open none."""
    grid = op.grid_shape
    img = _randn(1, *grid, 2)
    vals = _randn(1, int(op.points.shape[0]), 2)
    slots = _randn(1, op.num_slots, 2)
    weights = op.slot_weights(torch.rand(int(op.points.shape[0])))
    adj = op.adjoint()
    return {
        "type_2": (lambda: op(img), []),
        "type_1": (lambda: adj(vals), ["plan.apply"] + T1),
        "normal": (lambda: op.normal(img, weights), ["plan.normal"] + T2
                   + T1),
        "apply_to_slots": (lambda: op.apply_to_slots(img),
                           ["plan.slots"] + T2),
        "apply_from_slots": (lambda: adj.apply_from_slots(slots),
                             ["plan.slots"] + T1),
        "to_slots": (lambda: op.to_slots(vals), []),
        "from_slots": (lambda: op.from_slots(slots), []),
    }


@pytest.mark.parametrize("case", ["type_2", "type_1", "normal",
                                  "apply_to_slots", "apply_from_slots",
                                  "to_slots", "from_slots"])
@pytest.mark.parametrize("rank", [2, 3])
def test_planned_applies_open_plan_and_stage_spans(rank, case):
    op = planar.PlannedNufft(_points(rank), GRIDS[rank], device="cpu")
    assert op.level != "none"
    fn, expect = _planned_calls(op)[case]
    spans = _spans(fn)
    assert [s[0] for s in spans] == expect
    assert all(_inside(s, spans[0]) for s in spans[1:])


@pytest.mark.parametrize("fused", [False, True])
def test_banded_type1_routes_open_the_stage_spans(monkeypatch, fused):
    """The rank-3 banded type-1, staged and fused (``FUSED_DFTA``), runs
    its spread and mode stage under the stage spans."""
    monkeypatch.setattr(binning, "MATS_BYTES_BUDGET", 0)
    op = planar.PlannedNufft(_points(3, 3000, seed=11), (24, 16, 16),
                             "type_1", device="cpu")
    assert op.level == "binned" and op.band_info is not None
    monkeypatch.setattr(planar_fft, "FUSED_DFTA", fused)
    assert planar_fft.fused_route(op.geom, op.band_info) == fused
    spans = _spans(lambda: op(_randn(1, 3000, 2)))
    assert [s[0] for s in spans] == ["plan.apply"] + T1


def _sense():
    grid = GRIDS[2]
    return mri.SenseNufft(_points(2), _randn(3, *grid, 2), grid,
                          density=torch.rand(M), device="cpu")


def test_cg_sense_opens_one_span_per_iteration():
    op = _sense()
    assert op._t2.level != "none"
    kspace = op.forward(_randn(*GRIDS[2], 2))
    spans = _spans(lambda: mri.cg_sense(kspace, op, num_iters=3))
    iters = [s for s in spans if s[0] == "cg.iter"]
    assert len(iters) == 3
    assert [s[0] for s in spans if s[0].startswith("mri.")] == \
        ["mri.adjoint"] + ["mri.normal"] * 3
    for it in iters:
        normals = [s for s in spans if s[0] == "mri.normal"
                   and _inside(s, it)]
        assert len(normals) == 1
        plans = [s for s in spans if s[0].startswith("plan.")
                 and _inside(s, normals[0])]
        assert [s[0] for s in plans] == ["plan.normal"]


@pytest.mark.parametrize("rank", [2, 3])
def test_training_step_bins_three_times(rank):
    """A type-2 loss, backward to the image and the points: the forward,
    the image gradient's type-1 and the points gradient's mode-weighted
    type-2 each bin the points once, inside their fold."""
    x = _randn(1, *GRIDS[rank], 2).requires_grad_()
    k = _points(rank).requires_grad_()

    def step():
        out = planar.nufft(x, k, device="cpu")
        out.square().sum().backward()

    spans = _spans(step)
    bins = [s for s in spans if s[0] == "prep.bin"]
    folds = [s for s in spans if s[0] == "nufft.fold_rescale"]
    assert len(bins) == 3 and len(folds) == 3
    assert all(_inside(b, f) for b, f in zip(bins, folds))
    assert x.grad is not None and k.grad is not None


def _path(name):
    if name == "planned":
        calls = _planned_calls(planar.PlannedNufft(_points(2), GRIDS[2],
                                                   device="cpu"))

        def run():
            for fn, _ in calls.values():
                fn()
        return run
    if name == "cg_sense":
        op = _sense()
        kspace = op.forward(_randn(*GRIDS[2], 2))
        return lambda: mri.cg_sense(kspace, op, num_iters=2)
    x = _randn(1, *GRIDS[3], 2).requires_grad_()
    k = _points(3).requires_grad_()
    return lambda: planar.nufft(x, k, device="cpu").square().sum().backward()


@pytest.mark.parametrize("name", ["planned", "cg_sense", "training"])
def test_no_record_function_without_a_profiler(monkeypatch, name):
    opened = []
    real = torch.profiler.record_function

    def counting(span, *args):
        opened.append(span)
        return real(span, *args)

    run = _path(name)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    run()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    assert opened      # the same calls open them under a profiler
