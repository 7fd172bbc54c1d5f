"""Smoke run of the PyTorch port (tensorflow_nufft_tpu_torch) on one GPU.

Drives the port's main path -- the planar 2D NUFFT of bench.py's headline:
256^2 modes, 65,536 uniform points, tol 1e-6, seed 42 -- through the
entry points a user calls, on the card, with no JAX:

1. Environment: torch, CUDA and nvcc versions, the card's name and power
   limit. Fails when torch sees no CUDA device.
2. Build: compiles the hand-written kernels (csrc/*.cu, nvcc, sm_90a).
3. Kernels: at the headline geometry, with 2 and 8 channels, runs the
   spread and interp kernels from both weight sources (planned windows,
   in-kernel evaluation) and holds each to its plain PyTorch version on
   the same inputs: max |kernel - plain| <= 1e-5 * max |plain| (f32
   summation order).
4. End to end: zeroes the launch counters, runs PlannedNufft and
   planar.nufft, type-1 and type-2, and checks that every kernel was
   launched; then gates each result against the exact NUDFT (complex128
   on the card, < 10 * tol relative to the peak) and against the port's
   own float64 plain pipeline on the CPU (< tol).
5. Times (CUDA events, median of 25 runs after warm-up): each kernel and
   its plain version, and the planned type-1 transform (points/s).

Prints the kernels as one JSON line, then the nvidia-smi line, then, last,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.

Usage: python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

GRID = 256
NUM_POINTS = 65536
TOL = 1e-6
SEED = 42
KERNEL_RTOL = 1e-5
WARMUP = 3
REPS = 25


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS, warmup=WARMUP):
    """Median device time of ``fn`` in ms (CUDA events around each
    call, after ``warmup`` untimed calls)."""
    import torch
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


def rel_err(got, ref):
    import torch
    got = got.to(torch.complex128) if got.is_complex() else got.double()
    ref = ref.to(got.dtype)
    return float((got - ref).abs().max() / ref.abs().max())


def inputs():
    """bench.py's headline points and strengths (seed 42)."""
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-np.pi, np.pi, (NUM_POINTS, 2)).astype(np.float32)
    z = (rng.standard_normal(NUM_POINTS)
         + 1j * rng.standard_normal(NUM_POINTS)).astype(np.complex64)
    modes = (rng.standard_normal((GRID, GRID))
             + 1j * rng.standard_normal((GRID, GRID))).astype(np.complex64)
    return rng, points, z, modes


def environment():
    import torch
    from tensorflow_nufft_tpu_torch.kernels import _build
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    # The slice has no matmul; the NUDFT oracle does, and must be full f32
    # or f64 arithmetic.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def build():
    from tensorflow_nufft_tpu_torch.kernels import _build
    start = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - start:.1f} s "
        f"(nvcc ran: {_build.BuildInfo.compiled}, "
        f"{_build.BuildInfo.seconds:.1f} s) -> {_build.BuildInfo.path}")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


KERNELS = {
    # name: (source, TPU kernel it replaces)
    "spread_planned": ("tensorflow_nufft_tpu_torch/csrc/spread.cu",
                       "tensorflow_nufft_tpu/kernels/pallas_spread.py:518"),
    "spread_unplanned": ("tensorflow_nufft_tpu_torch/csrc/spread.cu",
                         "tensorflow_nufft_tpu/kernels/pallas_spread.py:582"),
    "interp_planned": ("tensorflow_nufft_tpu_torch/csrc/interp.cu",
                       "tensorflow_nufft_tpu/kernels/pallas_interp.py:152"),
    "interp_unplanned": ("tensorflow_nufft_tpu_torch/csrc/interp.cu",
                         "tensorflow_nufft_tpu/kernels/pallas_interp.py:218"),
}


def wrappers():
    from tensorflow_nufft_tpu_torch.kernels import interp, spread
    return {"spread_planned": spread.spread_planned_cuda,
            "spread_unplanned": spread.spread_unplanned_cuda,
            "interp_planned": interp.interp_planned_cuda,
            "interp_unplanned": interp.interp_unplanned_cuda}


def kernel_phase(rng, points, dev):
    """Each kernel against its plain version at the headline geometry."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

    plan = make_plan(PlanSpec("type_1", "forward", 2, (GRID, GRID),
                              "complex64", TOL, 1))
    geom, binned = bin_for_plan(torch.from_numpy(points).to(dev), plan)
    log(f"plan: width {plan.width} sigma {plan.sigma} fine "
        f"{plan.fine_shape} horner terms {len(plan.horner)}; geometry: "
        f"tiles {geom.tiles} x {geom.tile} ext {geom.ext} chunk "
        f"{geom.chunk} chunks {geom.num_chunks} (used "
        f"{int(binned.tile_bounds[-1])})")
    kw = binning.build_weight_payload(binned, geom, plan)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    wrap = wrappers()
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for b2 in (2, 8):
        values_cm = torch.from_numpy(
            rng.standard_normal((b2, NUM_POINTS)).astype(np.float32)).to(dev)
        values_pl = binning.build_values_payload(values_cm, binned)
        tiles = torch.from_numpy(rng.standard_normal(
            geom.tiles + (b2,) + geom.ext).astype(np.float32)).to(dev)
        cases = {
            "spread_planned": (
                lambda: wrap["spread_planned"](values_pl, tb, geom, plan, kw),
                lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                                  kw=kw)),
            "spread_unplanned": (
                lambda: wrap["spread_unplanned"](values_pl, tb, geom, plan,
                                                 coords),
                lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                                  coords=coords)),
            "interp_planned": (
                lambda: wrap["interp_planned"](tiles, tb, geom, plan, kw),
                lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                                  kw=kw)),
            "interp_unplanned": (
                lambda: wrap["interp_unplanned"](tiles, tb, geom, plan,
                                                  coords),
                lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                                  coords=coords)),
        }
        for name, (kernel, plain) in cases.items():
            before = wrap[name].launches
            got = kernel()
            torch.cuda.synchronize()
            if wrap[name].launches != before + 1:
                raise RuntimeError(f"{name}: launch counter did not rise")
            ref = plain()
            err = float((got - ref).abs().max())
            peak = float(ref.abs().max())
            log(f"kernel {name} B2={b2}: max|kernel - plain| {err:.3e} "
                f"(peak {peak:.3e}, bound {KERNEL_RTOL * peak:.3e})")
            if not (np.isfinite(err) and err <= KERNEL_RTOL * peak):
                raise RuntimeError(f"{name} B2={b2} disagrees with its plain "
                                   f"version: {err:.3e} > "
                                   f"{KERNEL_RTOL:g} * {peak:.3e}")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if b2 == 2:
                res["ms"] = cuda_ms(kernel)
                res["plain_ms"] = cuda_ms(plain)
                log(f"time {name} B2=2: kernel {res['ms']:.4f} ms, plain "
                    f"{res['plain_ms']:.4f} ms")
    return results


def exact_type1(points, z, dev):
    import torch
    x = torch.from_numpy(points.astype(np.float64)).to(dev)
    c = torch.from_numpy(z.astype(np.complex128)).to(dev)
    k = torch.arange(GRID, dtype=torch.float64, device=dev) - GRID // 2
    ax = torch.exp(-1j * torch.outer(x[:, 0], k))
    ay = torch.exp(-1j * torch.outer(x[:, 1], k))
    return (ax * c[:, None]).T @ ay                     # [k0, k1]


def exact_type2(points, modes, dev):
    import torch
    x = torch.from_numpy(points.astype(np.float64)).to(dev)
    f = torch.from_numpy(modes.astype(np.complex128)).to(dev)
    k = torch.arange(GRID, dtype=torch.float64, device=dev) - GRID // 2
    ax = torch.exp(-1j * torch.outer(x[:, 0], k))
    ay = torch.exp(-1j * torch.outer(x[:, 1], k))
    return torch.sum(ax * (ay @ f.T), dim=1)            # [M]


def end_to_end(points, z, modes, dev):
    """The main path at the headline config, with launch counting."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar

    grid = (GRID, GRID)
    pts = torch.from_numpy(points).to(dev)
    strengths = to_planar(z).to(dev)
    modes_p = to_planar(modes).to(dev)
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    op1 = tnt.PlannedNufft(pts, grid, transform_type="type_1", tol=TOL)
    t1_planned = op1(strengths[None])[0]
    t1_unplanned = tnt.planar.nufft(strengths, pts, grid_shape=grid,
                                    transform_type="type_1", tol=TOL)
    op2 = tnt.PlannedNufft(pts, grid, transform_type="type_2", tol=TOL)
    t2_planned = op2(modes_p[None])[0]
    t2_unplanned = tnt.planar.nufft(modes_p, pts, transform_type="type_2",
                                    tol=TOL)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrap.items()}
    log(f"main-path launches: {launches}")
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise RuntimeError(f"main path did not launch {missing}")

    outs = {"t1_planned": t1_planned, "t1_unplanned": t1_unplanned,
            "t2_planned": t2_planned, "t2_unplanned": t2_unplanned}
    for name, out in outs.items():
        expect = (grid + (2,)) if name.startswith("t1") else (NUM_POINTS, 2)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: shape {tuple(out.shape)} (want "
                               f"{expect}) or non-finite values")
    log(f"planned vs unplanned max abs diff: type-1 "
        f"{float((t1_planned - t1_unplanned).abs().max()):.3e}, type-2 "
        f"{float((t2_planned - t2_unplanned).abs().max()):.3e}")

    exact1 = exact_type1(points, z, dev)
    exact2 = exact_type2(points, modes, dev)
    # The port's own float64 plain pipeline (CPU tensors -> plain
    # versions), same tol: the implementation-error reference.
    pts64 = torch.from_numpy(points.astype(np.float64))
    ref1 = from_planar(tnt.planar.nufft(
        to_planar(z.astype(np.complex128)), pts64, grid_shape=grid,
        transform_type="type_1", tol=TOL))
    ref2 = from_planar(tnt.planar.nufft(
        to_planar(modes.astype(np.complex128)), pts64,
        transform_type="type_2", tol=TOL))
    gates = []
    for name, out in outs.items():
        got = from_planar(out).cpu()
        exact = (exact1 if name.startswith("t1") else exact2).cpu()
        ref = ref1 if name.startswith("t1") else ref2
        err_total = rel_err(got, exact)
        err_impl = float((got.to(torch.complex128) - ref).abs().max()
                         / exact.abs().max())
        log(f"{name}: err_total (vs exact NUDFT) {err_total:.3e} "
            f"(gate < {10 * TOL:g}); err_impl (vs f64 plain pipeline) "
            f"{err_impl:.3e} (gate < {TOL:g})")
        gates.append((name, err_total < 10 * TOL and err_impl < TOL))
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise RuntimeError(f"accuracy gates failed: {failed}")
    return launches, op1, op2, pts, strengths, modes_p


def transform_times(op1, op2, pts, strengths, modes_p):
    import tensorflow_nufft_tpu_torch as tnt
    grid = (GRID, GRID)
    src1 = strengths[None]
    src2 = modes_p[None]
    times = {
        "t1_planned": cuda_ms(lambda: op1(src1)),
        "t1_unplanned": cuda_ms(lambda: tnt.planar.nufft(
            strengths, pts, grid_shape=grid, transform_type="type_1",
            tol=TOL)),
        "t2_planned": cuda_ms(lambda: op2(src2)),
        "t2_unplanned": cuda_ms(lambda: tnt.planar.nufft(
            modes_p, pts, transform_type="type_2", tol=TOL)),
    }
    for name, ms in times.items():
        log(f"time {name}: {ms:.4f} ms per transform, "
            f"{NUM_POINTS / (ms * 1e-3):.4e} points/s")
    return times


def main():
    smi = environment()
    import torch
    dev = torch.device("cuda", 0)
    build()
    rng, points, z, modes = inputs()
    results = kernel_phase(rng, points, dev)
    launches, op1, op2, pts, strengths, modes_p = end_to_end(
        points, z, modes, dev)
    transform_times(op1, op2, pts, strengths, modes_p)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        res = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
