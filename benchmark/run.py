"""Runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the inputs from the seed on the card, builds the program's
object and warms up every shape the cell uses; the window then calls the
program for ``--seconds`` (``--trace 1``: under ``torch.profiler``, for
the traffic's ``trace_seconds`` at most). Once the window has closed,
the peak memory is read, the program's state is freed and the plain
reference judges a seeded sample of the window's answers. The last lines
of standard error give each compared number beside its limit; the last
line of standard output is the result, with the ``--trace 0`` run's
end-to-end metrics or the ``--trace 1`` run's per-layer ones.

Exits with another code than 0, and prints no result, where the checkout
holds no ``tensorflow_nufft_tpu_torch``, where there is no CUDA card (or
fewer than the cell asks for), or where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "tensorflow_nufft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorflow_nufft_tpu")


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)
        start = int(fields[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age()


def setup_seconds() -> float:
    return AGE_AT_START + time.perf_counter() - T_START


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": _power_limit()}


def _finite(value: float):
    return value if math.isfinite(value) else str(value)


def build_cell(name: str, seed: int, device, config=None, traffic=None,
               root=ROOT):
    """(cell, traffic): the entry's cell of workload ``name``, its
    inputs made from ``seed`` on ``device``."""
    import torch
    from benchmark import spec
    from benchmark.traffic import Inputs
    bench = spec.load(root)
    cell_spec = spec.workload(bench, name)
    config = config or spec.config(bench, cell_spec["config"], root)
    traffic = traffic or spec.traffic(cell_spec["traffic"],
                                      root / "benchmark")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                inputs=Inputs(seed, device))
    return entry.build(ctx), traffic


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             config=None, traffic=None, limits=None, root=ROOT):
    """Runs cell ``name`` once on ``device``; returns (result, checks):
    the result line's dict and {number: (value, limit)}. ``config``,
    ``traffic`` and ``limits`` replace the cell's files (tests run small
    copies on the CPU)."""
    import torch
    from benchmark import spec, tracing, window

    bench_dir = root / "benchmark"
    bench = spec.load(root)
    cell_spec = spec.workload(bench, name)
    limits = limits or spec.limits(name, bench_dir)
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t_build = setup_seconds()
    cell, traffic = build_cell(name, seed, device, config, traffic, root)
    t_warm = setup_seconds()
    cell.warmup()
    sync()
    keep = window.Reservoir(traffic["kept"], seed)
    setup_s = setup_seconds()
    traced = None
    if trace:
        length = min(seconds, traffic.get("trace_seconds", seconds))
        with tracing.profiler() as prof:
            with tracing.window_span():
                record = window.run(cell.call, cell.waited, length, keep,
                                    sync)
        traced = tracing.Trace(prof.events())
    else:
        record = window.run(cell.call, cell.waited, seconds, keep, sync)
    dev_info = device_info(device, cell_spec["chips"])
    run = types.SimpleNamespace(cell=cell, window=record, setup_s=setup_s,
                                trace=traced)
    metrics = {}
    for entry_spec, definition in spec.metrics(bench, name, trace, bench_dir):
        reader = importlib.import_module(
            f"benchmark.readers.{definition['reader']}")
        value = reader.read(definition, run)
        if value is not None:
            metrics[entry_spec["name"]] = {**value,
                                           "unit": entry_spec["unit"]}
    breakdown = traced.breakdown() if traced is not None else None

    # The reference: after the window, the peak's reading and the
    # release of the program's state.
    answers = cell.answers(keep.items)
    keep.items.clear()
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = {}, 0
    for p, entries in answers:
        bad = False
        for key, value in cell.judge(p, entries).items():
            if value != value:                                  # NaN
                value = math.inf
            bad |= not value <= limits[key]
            if key not in checks or value > checks[key][0]:
                checks[key] = (value, limits[key])
        failed += bad
    correct = bool(answers) and failed == 0
    print(f"{name} seed {seed}: set-up {setup_s:.3f} s (build from "
          f"{t_build:.3f} s, warm-up from {t_warm:.3f} s), {record.calls} "
          f"calls in {record.seconds:.3f} s, reference "
          f"{time.perf_counter() - t_ref:.3f} s for {len(answers)} "
          f"answers", file=sys.stderr)
    result = {"correct": correct, "attempted": record.calls,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        if breakdown:
            result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    # One process with few threads: the host's other cores stay free for
    # the card's runtime, and the host-paced cells spread less.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"no {PACKAGE} beside benchmark/ in {ROOT}: nothing to "
              f"measure", file=sys.stderr)
        return 2
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if pathlib.Path(p or ".").resolve()
                                 != ROOT / "benchmark"]
    from benchmark import spec
    chips = spec.workload(spec.load(ROOT), args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 3
    import tensorflow_nufft_tpu_torch
    if pathlib.Path(tensorflow_nufft_tpu_torch.__file__).resolve().parent \
            != ROOT / PACKAGE:
        print(f"{PACKAGE} was loaded from outside {ROOT}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}; no result",
              file=sys.stderr)
        return 4
    for key, (value, limit) in checks.items():
        print(f"check {key} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
