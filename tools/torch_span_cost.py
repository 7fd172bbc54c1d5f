"""Times the unplanned 2D transforms of the PyTorch port at bench.py's
headline (256^2 modes, 65,536 uniform points, tol 1e-6, seed 42) on one
GPU, to read what the stage spans (``record_function`` around each
stage, no profiler active) cost a call.

Prints one JSON line: the package's path, the CUDA-event and host
wall-clock medians of 25 calls (after 3 warm-up calls) of the unplanned
``planar.nufft`` type-1 and type-2, and the host cost of one enter and
exit without a profiler of ``record_function`` and of the tree's
``utils.profiling.scope`` (null where the tree has none; median of 5
batches of 20,000). Run it with two trees' packages first on PYTHONPATH,
in turns, to compare them (the script runs against any tree of the
port):

    for t in <parent> . . <parent>; do
        PYTHONPATH=$t python3 tools/torch_span_cost.py; done

Usage: python3 tools/torch_span_cost.py
"""

import json
import statistics
import time

import numpy as np
import torch

import tensorflow_nufft_tpu_torch as tnt

GRID, NUM_POINTS, TOL, SEED = 256, 65536, 1e-6, 42
REPS, WARMUP = 25, 3


def medians(fn):
    """(CUDA-event median, host wall median) of ``fn`` in ms."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    events, walls = [], []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return statistics.median(events), statistics.median(walls)


def span_us(span, n=20_000):
    """Host microseconds of one enter + exit of ``span("nufft.spread")``
    without a profiler."""
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("nufft.spread"):
                pass
        runs.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(runs)


def scope_us():
    """``span_us`` of the tree's ``utils.profiling.scope``, or None for a
    tree without it."""
    try:
        from tensorflow_nufft_tpu_torch.utils import profiling
    except ImportError:
        return None
    return span_us(profiling.scope)


def main():
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-np.pi, np.pi, (NUM_POINTS, 2)).astype(np.float32)
    z = (rng.standard_normal(NUM_POINTS)
         + 1j * rng.standard_normal(NUM_POINTS)).astype(np.complex64)
    modes = (rng.standard_normal((GRID, GRID))
             + 1j * rng.standard_normal((GRID, GRID))).astype(np.complex64)
    pts = torch.from_numpy(points).to(dev)
    vals = torch.view_as_real(torch.from_numpy(z)).to(dev)
    grid = torch.view_as_real(torch.from_numpy(modes)).to(dev)
    t1 = medians(lambda: tnt.planar.nufft(
        vals, pts, grid_shape=(GRID, GRID), transform_type="type_1",
        tol=TOL))
    t2 = medians(lambda: tnt.planar.nufft(grid, pts, transform_type="type_2",
                                          tol=TOL))
    print(json.dumps({
        "package": tnt.__file__.rsplit("/", 2)[0],
        "t1_unplanned_event_ms": t1[0], "t1_unplanned_host_ms": t1[1],
        "t2_unplanned_event_ms": t2[0], "t2_unplanned_host_ms": t2[1],
        "record_function_us": span_us(torch.profiler.record_function),
        "scope_us": scope_us(),
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
