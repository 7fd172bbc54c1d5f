"""Probe of the PyTorch port's rank-1 spread and interp kernels on one GPU.

Prints the SHA-256 of the kernels' outputs on seeded inputs and their
CUDA-event medians at the shapes of the 1D main path: the 1D headline
(2^20 modes, 10^7 uniform points, tol 1e-6, seed 42; the unplanned
spread and interp at B2 2 and 8, the spread from slot-order values, the
phi' interp) and the 1D mats size (65,536 modes, the first 16,384
headline points; the planned spread and interp from the planned
windows). The hashes let two trees be compared bit for bit: run the
probe once with this tree's package and once with another checkout's
first on PYTHONPATH, in turns (PYTHONPATH=<tree> python3
tools/torch_line_probe.py). Only the kernels' wrappers are called, so
any tree with the rank-1 kernels runs it.

--device  also prints each call's device time: the kernels' time per
          call from torch.profiler over 20 calls (the CUDA-event time
          around a wrapper includes its host time, which dominates at the
          mats size).

Usage: python3 tools/torch_line_probe.py [--device]
"""

import hashlib
import statistics
import subprocess
import sys

import numpy as np
import torch

import tensorflow_nufft_tpu_torch
from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

NUM_POINTS = 10_000_000
GRID = 2 ** 20
MATS_GRID = 65_536
MATS_POINTS = 16_384


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each
    call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls=20):
    """Device time per call of ``fn``: the CUDA kernels' summed time
    under torch.profiler, / ``calls``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls / 1e3


def sha(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def layout(grid, points):
    dev = torch.device("cuda")
    plan = make_plan(PlanSpec("type_1", "forward", 1, (grid,), "complex64",
                              1e-6, 1))
    geom, binned = bin_for_plan(torch.from_numpy(points).to(dev), plan)
    return plan, geom, binned


def headline_cases(points):
    """(label, call) of the unplanned rank-1 kernels at the headline."""
    dev = torch.device("cuda")
    plan, geom, binned = layout(GRID, points)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    gen = torch.Generator(device=dev).manual_seed(52)
    out = []
    for b2 in (2, 8):
        vals = binning.build_values_payload(torch.randn(
            (b2, NUM_POINTS), generator=gen, device=dev), binned)
        tiles = torch.randn(geom.tiles + (b2,) + geom.ext, generator=gen,
                            device=dev)
        out.append((f"spread unplanned B2 {b2}",
                    lambda v=vals: spread.spread_unplanned_cuda(
                        v, tb, geom, plan, coords)))
        out.append((f"interp unplanned B2 {b2}",
                    lambda f=tiles: interp.interp_unplanned_cuda(
                        f, tb, geom, plan, coords)))
        if b2 == 2:
            slots = torch.randn((2, geom.num_slots), generator=gen,
                                device=dev)
            out.append(("spread slot-order values B2 2",
                        lambda v=slots: spread.spread_unplanned_cuda(
                            v, tb, geom, plan, coords)))
            out.append(("interp phi' B2 2",
                        lambda f=tiles: interp.interp_deriv_cuda(
                            f, tb, geom, plan, coords, 0)))
    return out


def mats_cases(points):
    """(label, call) of the planned rank-1 kernels at the mats size."""
    dev = torch.device("cuda")
    plan, geom, binned = layout(MATS_GRID, points[:MATS_POINTS])
    kw = binning.build_weight_payload(binned, geom, plan)
    tb = binned.tile_bounds
    gen = torch.Generator(device=dev).manual_seed(53)
    vals = binning.build_values_payload(torch.randn(
        (2, MATS_POINTS), generator=gen, device=dev), binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    return [("spread planned B2 2", lambda: spread.spread_planned_cuda(
                 vals, tb, geom, plan, kw)),
            ("interp planned B2 2", lambda: interp.interp_planned_cuda(
                tiles, tb, geom, plan, kw))]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: the probe "
                         "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"package {tensorflow_nufft_tpu_torch.__file__}; {smi}",
          flush=True)
    rng = np.random.default_rng(42)
    points = rng.uniform(-np.pi, np.pi, (NUM_POINTS, 1)).astype(np.float32)
    for tag, cases in (("1d", headline_cases), ("1d_mats", mats_cases)):
        for label, fn in cases(points):
            line = f"{tag} {label}: {sha(fn())} {cuda_ms(fn):.4f} ms"
            if "--device" in sys.argv:
                line += f", device {device_ms(fn):.4f} ms"
            print(line, flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
