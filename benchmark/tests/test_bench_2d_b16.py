"""The upstream 2D case's cell, ``2d_256_200k_b16_t1``, at a small size
on the CPU: its files and metrics, its unbroken run, its control and an
altered answer, and its per-layer metrics read from a profiled run."""

import math
import types

import pytest

from benchmark import run, spec, tracing
from benchmark.entries import planned

CELL = "2d_256_200k_b16_t1"
METRICS = ["idle_pct.nufft2d", "spread_roofline.nufft2d", "mode_ms.nufft2d",
           "launches.nufft2d"]
OLD_CELLS = ("3d_128_800k_t1", "3d_128_800k_t2", "3d_128_800k_train",
             "rrsg_brain_cgsense")


def _small():
    """(config, traffic): the cell's files at modes 16^2 and 3000 points,
    batch 16 kept."""
    bench = spec.load()
    w = spec.workload(bench, CELL)
    config = dict(spec.config(bench, w["config"]), modes=[16, 16],
                  points={"kind": "uniform", "count": 3000})
    traffic = dict(spec.traffic(w["traffic"]), check_size=64)
    assert traffic["batch"] == 16
    return config, traffic


def _run(seed=2147483661, trace=False, seconds=0.3):
    config, traffic = _small()
    return run.run_cell(CELL, seed, seconds, trace, "cpu", config=config,
                        traffic=traffic)


def test_cell_and_its_metrics_are_listed():
    bench = spec.load()
    assert spec.problems(bench) == []
    assert [m["name"] for m, _ in spec.metrics(bench, CELL, True)] == METRICS
    assert {m["name"] for m, _ in spec.metrics(bench, CELL, False)} == \
        {"nupts_per_s", "setup_s"}
    for cell in OLD_CELLS:
        names = {m["name"] for m, _ in spec.metrics(bench, cell, True)}
        assert not names & set(METRICS)


def test_unbroken_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(checks) == set(spec.limits(CELL)) == {"rel_err"}
    assert set(result["metrics"]) == {"nupts_per_s", "setup_s"}


def test_control_fails_the_limit():
    config, traffic = _small()
    built, traffic = run.build_cell(CELL, 2147483662, "cpu", config, traffic)
    built.release()
    limit = spec.limits(CELL)["rel_err"]
    readings = [built.judge(p, entries)["rel_err"]
                for p, entries in built.control(traffic["kept"])]
    assert readings and min(readings) > limit


def test_altered_answer_is_not_correct(monkeypatch):
    call = planned.Planned.call
    monkeypatch.setattr(planned.Planned, "call",
                        lambda self, i: call(self, i) * (1 + 1e-3))
    result, _ = _run()
    assert not result["correct"] and result["failed"] > 0


def _as_if_launched(events):
    """The CPU profile's events, with each outermost aten op also given
    as a kernel launched from the host at its start, run on the device
    over its interval (on the CPU the ops run where a card would run
    the kernels)."""
    from torch.autograd import DeviceType

    def event(name, start, end, eid, device):
        return types.SimpleNamespace(
            name=name, id=eid, is_user_annotation=False,
            device_type=DeviceType.CUDA if device else DeviceType.CPU,
            time_range=types.SimpleNamespace(start=start, end=end))

    out = list(events)
    for i, e in enumerate(events):
        parent = e.cpu_parent
        if e.name.startswith("aten::") and not (
                parent is not None and parent.name.startswith("aten::")):
            eid = 10 ** 12 + i
            out.append(event("cudaLaunchKernel", e.time_range.start,
                             e.time_range.start, eid, False))
            out.append(event(f"k_{e.name}", e.time_range.start,
                             e.time_range.end, eid, True))
    return out


def test_traced_run_reads_the_new_metrics(monkeypatch):
    """The metrics' span names are the ones the planned type-1 path
    opens: each reads a value from a profiled run whose ops stand for
    kernels."""
    kept = []

    class Launched(tracing.Trace):
        def __init__(self, events):
            super().__init__(_as_if_launched(events))
            kept.append(self)

    monkeypatch.setattr(tracing, "Trace", Launched)
    result, _ = _run(trace=True, seconds=0.2)
    trace, calls = kept[0], result["attempted"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(METRICS)
    assert all(math.isfinite(v) and v > 0 for v in metrics.values())
    assert metrics["launches.nufft2d"] == trace.kernel_launches() / calls
    assert metrics["mode_ms.nufft2d"] == pytest.approx(
        1e3 * trace.seconds("spans", ["nufft.mode_dft_deconvolve"]) / calls)
    spread_s = trace.seconds("spans", ["nufft.spread"])
    assert 0 < spread_s < trace.seconds("spans", ["plan.apply"])


def test_small_run_keeps_the_batch():
    config, traffic = _small()
    cell, _ = run.build_cell(CELL, 2147483663, "cpu", config, traffic)
    assert cell.work == {"points": 3000 * 16}
    assert tuple(cell.call(0).shape) == (16, 16, 16, 2)
