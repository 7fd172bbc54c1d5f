"""The readers that split a traced window by the program's spans
(``idle_under``, ``launches_under``, ``span_count``, ``runtime_calls``):
known values on a hand-made trace, and on profiled CPU runs of the
CG-SENSE and training cells the splits add up to the whole."""

import importlib
import json
import types

import pytest

from benchmark import spec, tracing
from benchmark.readers import _spans, idle_pct, launches

from .conftest import ROOT, small_run

IDLE_RECON = ["idle_cg_ms.recon", "idle_sense_ms.recon",
              "idle_plan_ms.recon"]
LAUNCHES_RECON = ["launches_cg.recon", "launches_sense.recon",
                  "launches_plan.recon"]


def _event(name, start, end, device=False, mark=False, eid=0):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, id=eid, is_user_annotation=mark,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _span(name, start, end):
    return _event(name, start, end, mark=True)


def _launch(eid, at, kernel, start, end):
    return [_event("cudaLaunchKernel", at, at + 5, eid=eid),
            _event(kernel, start, end, device=True, eid=eid)]


def _hand_made():
    """A window of 1000 us and two calls: two CG iterations (the first
    with its normal, plan and spread spans), an adjoint, a binning;
    kernels launched at each depth, a copy, and runtime calls in and out
    of spans and of the window."""
    events = [
        _span("bench.window", 0, 1000),
        _span("prep.bin", 50, 80),
        _span("cg.iter", 100, 500),
        _span("mri.normal", 150, 450),
        _span("plan.normal", 200, 400),
        _span("nufft.spread", 250, 350),
        _span("cg.iter", 600, 900),
        _span("mri.adjoint", 920, 980),
        _span("prep.bin", 1100, 1200),                  # after the window
        _event("cudaStreamSynchronize", 60, 62),        # under prep.bin
        _event("cudaMemcpyAsync", 65, 66),              # not blocking
        _event("cudaMemcpy", 700, 705),                 # under cg.iter
        _event("cudaStreamSynchronize", 990, 995),      # under no span
        _event("cudaDeviceSynchronize", 1150, 1160),    # after the window
        _event("cudaMemcpyAsync", 610, 612, eid=7),
        _event("Memcpy DtoH", 615, 620, device=True, eid=7),
    ]
    events += _launch(5, 20, "k_none", 20, 30)
    events += _launch(1, 110, "k_cg", 120, 130)
    events += _launch(2, 160, "k_sense", 160, 170)
    events += _launch(3, 210, "k_plan", 300, 320)
    events += _launch(4, 260, "k_spread", 330, 340)
    events += _launch(6, 930, "k_adjoint", 940, 950)
    return types.SimpleNamespace(trace=tracing.Trace(events),
                                 window=types.SimpleNamespace(calls=2))


def _definition(metric):
    return json.loads((ROOT / "benchmark" / "metrics"
                       / f"{metric}.json").read_text())


def _read(metric, run):
    definition = _definition(metric)
    reader = importlib.import_module(
        f"benchmark.readers.{definition['reader']}")
    value = reader.read(definition, run)
    return None if value is None else value["value"]


def test_readers_give_the_hand_made_values():
    run = _hand_made()
    # Idle gaps (us) by innermost span at their midpoints: none 20,
    # prep.bin 90, cg.iter 30 + 275 + 320, plan.normal 130, nufft.spread
    # 10, mri.adjoint 50; per call in ms.
    assert _read("idle_cg_ms.recon", run) == pytest.approx(0.3125)
    assert _read("idle_sense_ms.recon", run) == pytest.approx(0.025)
    assert _read("idle_plan_ms.recon", run) == pytest.approx(0.07)
    assert _read("idle_prep_ms.train", run) == pytest.approx(0.045)
    # Kernels: one under cg.iter alone, two under mri.* without plan.*,
    # two under plan.*, one under no span; the copy is no launch.
    assert _read("launches_cg.recon", run) == 0.5
    assert _read("launches_sense.recon", run) == 1.0
    assert _read("launches_plan.recon", run) == 1.0
    assert _read("bins.train", run) == 0.5
    # The sync under prep.bin and the cudaMemcpy under cg.iter.
    assert _read("syncs.train", run) == 1.0


def test_innermost_span_is_the_latest_started_open_one():
    run = _hand_made()
    times = [10, 75, 145, 235, 325, 460, 780, 975, 1050]
    assert _spans.innermost(run.trace, times) == [
        None, "prep.bin", "cg.iter", "plan.normal", "nufft.spread",
        "cg.iter", "cg.iter", "mri.adjoint", None]


def _uncounted_idle_ms(run, metrics):
    """Idle ms per call under no span that one of ``metrics`` names."""
    wants = [_spans.matcher(_definition(m)["names"]) for m in metrics]
    us = sum(gap for gap, name in _spans.idle_by_span(run.trace)
             if name is None or not any(w(name) for w in wants))
    return us / 1e3 / run.window.calls


def _uncounted_launches(run, metrics):
    defs = [_definition(m) for m in metrics]

    def counted(names, d):
        under, not_under = (_spans.matcher(d["under"]),
                            _spans.matcher(d.get("not_under", [])))
        return any(map(under, names)) and not any(map(not_under, names))
    return sum(1 for names in _spans.launch_spans(run.trace)
               if not any(counted(names, d) for d in defs)) \
        / run.window.calls


def _check_sums(run):
    """The idle and launch splits of CG-SENSE add up to ``idle_pct``'s
    idle time (to 1e-9 s) and to ``launches`` exactly."""
    trace = run.trace
    idle_ms = 1e3 * (trace.window_s - trace.busy_s) / run.window.calls
    if trace.device:
        share = idle_pct.read({}, run)["value"] / 100.0
        assert share * trace.window_s * 1e3 / run.window.calls == \
            pytest.approx(idle_ms, abs=1e-6)
    split = sum(_read(m, run) for m in IDLE_RECON)
    assert split + _uncounted_idle_ms(run, IDLE_RECON) == \
        pytest.approx(idle_ms, abs=1e-6)
    total = trace.kernel_launches() / run.window.calls
    if trace.device:
        assert launches.read({}, run)["value"] == total
    assert sum(_read(m, run) for m in LAUNCHES_RECON) \
        + _uncounted_launches(run, LAUNCHES_RECON) == total


def test_splits_add_up_on_the_hand_made_trace():
    run = _hand_made()
    _check_sums(run)
    assert _uncounted_idle_ms(run, IDLE_RECON) == pytest.approx(0.055)
    assert _uncounted_launches(run, LAUNCHES_RECON) == 0.5


def test_readers_read_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None,
                                window=types.SimpleNamespace(calls=1))
    for metric in IDLE_RECON + LAUNCHES_RECON + [
            "idle_prep_ms.train", "bins.train", "syncs.train"]:
        assert _read(metric, run) is None


def _traced(monkeypatch, cell):
    """A small traced CPU run of ``cell``: (result, its run's fields)."""
    kept = []

    class Keep(tracing.Trace):
        def __init__(self, events):
            super().__init__(events)
            kept.append(self)

    monkeypatch.setattr(tracing, "Trace", Keep)
    result, _ = small_run(cell, trace=True, seconds=0.2)
    assert len(kept) == 1
    return result, types.SimpleNamespace(
        trace=kept[0], window=types.SimpleNamespace(
            calls=result["attempted"]))


def test_cgsense_splits_add_up_on_a_profiled_run(monkeypatch):
    result, run = _traced(monkeypatch, "rrsg_brain_cgsense")
    for metric in IDLE_RECON + LAUNCHES_RECON:
        assert result["metrics"][metric]["value"] == _read(metric, run)
    _check_sums(run)
    # Without a card the window is one gap, its midpoint inside a
    # reconstruction's spans.
    names = {n for _, n in _spans.idle_by_span(run.trace)}
    assert names and names <= {"cg.iter", "mri.normal", "mri.adjoint",
                               "plan.normal", "plan.apply",
                               "nufft.spread", "nufft.mode_dft_deconvolve",
                               "nufft.amplify_dft", "nufft.interp", None}


def test_train_step_bins_three_times_on_a_profiled_run(monkeypatch):
    result, run = _traced(monkeypatch, "3d_128_800k_train")
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["bins.train"] == 3.0
    assert metrics["syncs.train"] == 0.0           # no runtime on the CPU
    assert 0.0 <= metrics["idle_prep_ms.train"] <= \
        1e3 * run.trace.window_s / run.window.calls


def test_new_metrics_are_listed_for_their_cells():
    bench = spec.load()
    recon = [m["name"] for m, _ in spec.metrics(bench, "rrsg_brain_cgsense",
                                                True)]
    train = [m["name"] for m, _ in spec.metrics(bench, "3d_128_800k_train",
                                                True)]
    assert set(IDLE_RECON + LAUNCHES_RECON) <= set(recon)
    assert {"idle_prep_ms.train", "bins.train", "syncs.train"} <= set(train)
    for cell in ("3d_128_800k_t1", "3d_128_800k_t2"):
        names = {m["name"] for m, _ in spec.metrics(bench, cell, True)}
        assert not names & set(IDLE_RECON + LAUNCHES_RECON + [
            "idle_prep_ms.train", "bins.train", "syncs.train"])
