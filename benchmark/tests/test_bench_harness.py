"""The harness: the files BENCHMARK.json names, finding new files by
name, window statistics, the trace reduction, and the command's refusals
(no card, no program, JAX loaded)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
import types

import pytest

from benchmark import spec, tracing, window
from benchmark.readers import (window_mean_ms, window_percentile_ms,
                               window_rate)

from .conftest import ROOT, SMALL


def test_benchmark_json_and_its_files_load():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert spec.problems(bench) == []
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        e2e = [m for m, _ in spec.metrics(bench, w["name"], False)]
        per_layer = [m for m, _ in spec.metrics(bench, w["name"], True)]
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per_layer
        for m in per_layer:
            assert m["moves"] in names
        spec.traffic(w["traffic"])
        spec.limits(w["name"])


def test_names_and_units_use_the_allowed_characters():
    assert spec.NAME_RE.fullmatch("spread_roofline.nufft")
    assert not spec.NAME_RE.fullmatch("spread roofline")
    assert not spec.NAME_RE.fullmatch("a/b")
    assert spec.UNIT_RE.fullmatch("launches/step")
    assert not spec.UNIT_RE.fullmatch("points per second")
    bench = spec.load()
    bench["per_layer"][0]["unit"] = "µs"
    bench["workloads"][0]["name"] = "bad name"
    assert len(spec.problems(bench)) >= 2


def test_new_files_are_found_without_editing_any(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files, and listed in BENCHMARK.json, run."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load()
    config = dict(SMALL["tfnufft_3d_128_800k"], name="tiny_2d",
                  modes=[16, 16])
    (tmp_path / "benchmark/configs/tiny_2d.json").write_text(
        json.dumps(config))
    traffic = dict(spec.traffic("planned_t1_b1"), batch=2, check_size=32)
    (tmp_path / "benchmark/traffic/planned_t1_b2.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/tiny_2d_t1_b2.json").write_text(
        json.dumps({"rel_err": 1e-5}))
    (tmp_path / "benchmark/metrics/spread_ms.tiny.json").write_text(
        json.dumps({"reader": "device_ms", "match": "kernels",
                    "names": ["spread"]}))
    bench["configs"].append({"name": "tiny_2d", "source": "a test",
                             "file": "benchmark/configs/tiny_2d.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_2d_t1_b2", "config": "tiny_2d",
                               "traffic": "planned_t1_b2", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny_2d_t1_b2")
    bench["per_layer"].append({"name": "spread_ms.tiny", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "spread kernel",
                               "moves": "nupts_per_s",
                               "workloads": ["tiny_2d_t1_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(bench, tmp_path, tmp_path / "benchmark") == []
    from benchmark import run
    result, checks = run.run_cell("tiny_2d_t1_b2", 7, 0.2, False, "cpu",
                                  root=tmp_path)
    assert result["correct"] and set(checks) == {"rel_err"}
    assert set(result["metrics"]) == {"nupts_per_s", "setup_s"}
    metrics = [m["name"] for m, _ in spec.metrics(
        bench, "tiny_2d_t1_b2", True, tmp_path / "benchmark")]
    assert metrics == ["spread_ms.tiny"]


def test_rates_and_tails_are_over_all_requests():
    calls = []

    def call(i):
        calls.append(i)
        time.sleep(0.001 * (1 + (i % 3)))
        return i

    keep = window.Reservoir(4, 1)
    record = window.run(call, True, 0.1, keep, lambda: None)
    assert record.calls == len(calls) == len(record.latencies) == keep.seen
    assert record.seconds >= 0.1
    run = types.SimpleNamespace(window=record,
                                cell=types.SimpleNamespace(work={"n": 3}))
    rate = window_rate.read({"work": "n"}, run)["value"]
    assert rate == pytest.approx(3 * record.calls / record.seconds)
    mean = window_mean_ms.read({}, run)["value"]
    assert mean == pytest.approx(1e3 * record.seconds / record.calls)
    record.latencies = [float(v) for v in range(1, 101)]
    p95 = window_percentile_ms.read({"q": 95}, run)["value"]
    assert p95 == 95e3
    assert window.percentile([5.0, 1.0, 3.0], 95) == 5.0
    record.latencies = []
    assert window_percentile_ms.read({"q": 95}, run) is None


def test_reservoir_is_uniform_and_seeded():
    def sample(seed):
        keep = window.Reservoir(3, seed)
        for i in range(100):
            keep.offer(i)
        return keep.items
    assert sample(9) == sample(9) and sample(9) != sample(10)
    counts = [0] * 10
    for seed in range(2000):
        keep = window.Reservoir(1, seed)
        for i in range(10):
            keep.offer(i)
        counts[keep.items[0]] += 1
    assert min(counts) > 130 and max(counts) < 270


def _event(name, start, end, device=False, mark=False, eid=0):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, id=eid, is_user_annotation=mark,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    events = [
        _event("bench.window", 100, 1100, mark=True),
        _event("nufft.spread", 150, 300, mark=True),
        _event("cudaLaunchKernel", 160, 170, eid=7),
        _event("cudaLaunchKernel", 400, 410, eid=8),
        _event("aten::mul", 390, 420),
        _event("nufft.spread", 200, 700, device=True, mark=True),
        _event("spread_rows_kernel<3>", 200, 500, device=True, eid=7),
        _event("elementwise_kernel", 450, 600, device=True, eid=8),
        _event("Memcpy DtoD", 50, 120, device=True),
    ]
    t = tracing.Trace(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((120 - 100 + 600 - 200) * 1e-6)
    assert t.seconds("kernels", ["spread_rows"]) == pytest.approx(300e-6)
    assert t.seconds("spans", ["nufft.spread"]) == pytest.approx(300e-6)
    assert t.seconds("spans", ["nufft.interp"]) == 0
    assert t.kernel_launches() == 2
    brk = t.breakdown()
    assert brk["device_ops"][0] == ["spread_rows_kernel<3>",
                                    pytest.approx(300e-6)]
    assert dict(brk["idle_gaps"]) == {"cudaLaunchKernel": pytest.approx(80e-6),
                                      "(no host event)": pytest.approx(500e-6)}


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "3d_128_800k_t1",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env or os.environ)


def test_run_fails_without_a_card():
    out = _command(ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "tensorflow_nufft_tpu_torch" in out.stderr


def test_a_run_loads_no_jax():
    """Every module a cell's run loads, top-level names compared whole:
    the port's name starts with the JAX package's and is allowed."""
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import small_run\n"
        "from benchmark import run\n"
        "for cell in ('3d_128_800k_t1', '3d_128_800k_train',"
        " 'rrsg_brain_cgsense'):\n"
        "    small_run(cell, trace=True, seconds=0.05)\n"
        "import benchmark.control, benchmark.readers.device_roofline\n"
        "print(run.forbidden_modules())\n"
        "print('tensorflow_nufft_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"]
    assert run_forbidden(["jax.numpy", "tensorflow_nufft_tpu_torch.planar"]) \
        == ["jax"]
    assert run_forbidden(["tensorflow_nufft_tpu.ops"]) \
        == ["tensorflow_nufft_tpu"]


def run_forbidden(names):
    from benchmark import run
    saved = dict(sys.modules)
    try:
        for n in names:
            sys.modules.setdefault(n, types.ModuleType(n))
        return run.forbidden_modules()
    finally:
        for n in names:
            if n not in saved:
                del sys.modules[n]


def test_checkout_paths_hold_only_the_benchmark():
    bench = spec.load()
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert not any(pathlib.Path(ROOT / p).name.endswith("_torch")
                   for p in bench["paths"])
