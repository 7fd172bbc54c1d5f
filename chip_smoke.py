"""Smoke run of the PyTorch port (tensorflow_nufft_tpu_torch) on one GPU.

Drives the port's main paths through the entry points a user calls, on
the card, with no JAX:

- 2D: bench.py's headline, 256^2 modes, 65,536 uniform points, tol 1e-6,
  seed 42;
- 3D: bench_suite.py's 3d_t1_128_800k / 3d_t2_128_800k, 128^3 modes,
  800,000 uniform points, tol 1e-6, seed 42, batch 1 (fine grid 256^3,
  1024 tiles of ext (24, 24, 72), chunk 512, 2586 chunks).

Phases:

1. Environment: torch, CUDA and nvcc versions, the card's name and power
   limit. Fails when torch sees no CUDA device.
2. Build: compiles the hand-written kernels (csrc/*.cu, nvcc, sm_90a).
3. 2D kernels: at the 2D headline geometry, with 2 and 8 channels, runs
   the spread and interp kernels from both weight sources (planned
   windows, in-kernel evaluation) and holds each to its plain PyTorch
   version on the same inputs: max |kernel - plain| <= 1e-5 * max |plain|
   (f32 summation order).
4. 2D end to end: zeroes the launch counters, runs PlannedNufft and
   planar.nufft, type-1 and type-2, and checks that every 2D kernel was
   launched; then gates each result against the exact NUDFT (complex128
   on the card, < 10 * tol relative to the peak) and against the port's
   own float64 plain pipeline on the CPU (< tol).
5. 3D kernels: at the full 3D geometry, the eight rank-3 launches
   (planned and unplanned spread and interp, fold3d, truncate_
   deconvolve3d, amplify_pad3d, extend_tiles3d) against their plain
   versions on the card, with the same 1e-5 bound.
6. 3D end to end: zeroes the counters, runs PlannedNufft type-1 and its
   adjoint(), then planar.nufft type-1 and type-2, and checks that every
   3D kernel was launched. Gates, as bench_suite.py's 3D census:
   err_total < 10 * tol against the exact NUDFT in complex128 on a seeded
   subset (4096 modes over all points for type-1, 4096 points over all
   modes for type-2), and err_impl < max(tol, 4 * floor_f32) against the
   port's float64 plain pipeline, where floor_f32 is the port's float32
   plain pipeline's error against that same float64 one (both plain
   pipelines run on the card, called directly, not through dispatch).
7. Times (CUDA events, median of 25 runs after warm-up): each kernel and
   its plain version, the 2D and 3D transforms (points/s), the two 3D
   torch.fft calls and the 3D plan build. Each kernel's bound is the
   larger of its bytes over 3.35 TB/s and its float32 operations over
   67 TFLOP/s (H100 SXM data sheet), from this run's shapes.

8. With --profile only: for each transform and plan build of both
   paths, the CUDA-event median, the device busy time per call from
   torch.profiler (the sum of the device activities of 20 calls, / 20),
   the idle share 1 - busy / event time, and the largest device items.

Prints the kernels as one JSON line, then the nvidia-smi line, then, last,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.

Usage: python3 chip_smoke.py [--profile]
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

GRID = 256
NUM_POINTS = 65536
GRID3 = (128, 128, 128)
NUM_POINTS3 = 800_000
SUBSET = 4096
# The 3D geometry the port's choose_geometry gives at GRID3 / NUM_POINTS3.
GEOMETRY3 = dict(fine_shape=(256, 256, 256), tile=(16, 16, 64),
                 ext=(24, 24, 72), tiles=(16, 16, 4), chunk=512,
                 num_chunks=2586)
TOL = 1e-6
SEED = 42
KERNEL_RTOL = 1e-5
WARMUP = 3
REPS = 25
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


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


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_work(kind, planned, geom, plan, b2, m, used_slots):
    """(bytes, operations) of a spread or interp launch: each input read
    once and each output written once (slots of used chunks only), and
    3 (spread) or 2 (interp) operations per point, channel and window
    cell, plus the kernel evaluations of an unplanned launch."""
    r, w = geom.rank, plan.width
    cells = int(np.prod(geom.ext))
    tiles = 4 * geom.num_tiles * b2 * cells
    side = 4 * r * used_slots * (w + 1) if planned else 8 * r * used_slots
    evals = 0 if planned else m * r * w * (
        2 * len(plan.horner or ()) + 8)
    nbytes = tiles + side + 4 * (geom.num_tiles + 1) + 4 * b2 * used_slots
    per_cell = 3 if kind == "spread" else 2
    return nbytes, per_cell * b2 * m * w ** r + evals


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


_PS = "tensorflow_nufft_tpu/kernels/pallas_spread.py"
_PI = "tensorflow_nufft_tpu/kernels/pallas_interp.py"
_PD = "tensorflow_nufft_tpu/kernels/pallas_dft.py"
_CSRC = "tensorflow_nufft_tpu_torch/csrc/"
KERNELS = {
    # name: (wrapper, source, TPU kernel it replaces, rank)
    "spread_planned": ("spread.spread_planned_cuda", "spread.cu",
                       f"{_PS}:518", 2),
    "spread_unplanned": ("spread.spread_unplanned_cuda", "spread.cu",
                         f"{_PS}:582", 2),
    "interp_planned": ("interp.interp_planned_cuda", "interp.cu",
                       f"{_PI}:152", 2),
    "interp_unplanned": ("interp.interp_unplanned_cuda", "interp.cu",
                         f"{_PI}:218", 2),
    # At the 3D headline the JAX PlannedNufft takes its binned level: its
    # dense kernel matrices (6.36e8 B) exceed their 256 MiB budget. It then
    # runs the axis-0-banded kernels, whose tile blocks the port's planned
    # kernels compute on the unbanded geometry
    # (tests/test_torch_banded3d.py). The per-tile-grid mats kernels
    # (pallas_spread.py:1011, pallas_interp.py:373) serve 3D sizes whose
    # matrices fit.
    "spread3d_planned": ("spread.spread_planned_cuda", "spread.cu",
                         f"{_PS}:693", 3),
    "spread3d_unplanned": ("spread.spread_unplanned_cuda", "spread.cu",
                           f"{_PS}:638", 3),
    "interp3d_planned": ("interp.interp_planned_cuda", "interp.cu",
                         f"{_PI}:281", 3),
    "interp3d_unplanned": ("interp.interp_unplanned_cuda", "interp.cu",
                           f"{_PI}:218", 3),
    "fold3d": ("mode3d.fold3d_cuda", "mode3d.cu", f"{_PD}:346,362,384", 3),
    "truncate_deconvolve3d": ("mode3d.truncate_deconvolve3d_cuda",
                              "mode3d.cu", f"{_PD}:346,362,384", 3),
    "amplify_pad3d": ("mode3d.amplify_pad3d_cuda", "mode3d.cu",
                      f"{_PD}:222,246,261", 3),
    "extend_tiles3d": ("mode3d.extend_tiles3d_cuda", "mode3d.cu",
                       f"{_PD}:222,246,261", 3),
}


def wrappers():
    """Kernel name -> its CUDA wrapper (which holds the launch count)."""
    from tensorflow_nufft_tpu_torch.kernels import interp, mode3d, spread
    modules = {"spread": spread, "interp": interp, "mode3d": mode3d}
    out = {}
    for name, (path, _, _, _) in KERNELS.items():
        module, fn = path.split(".")
        out[name] = getattr(modules[module], fn)
    return out


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches(rank):
    """Launch counts of the kernels of the rank-``rank`` path; fails if
    one was launched no time."""
    launches = {name: fn.launches for name, fn in wrappers().items()
                if KERNELS[name][3] == rank}
    log(f"{rank}D main-path launches: {launches}")
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise RuntimeError(f"{rank}D main path did not launch {missing}")
    return launches


def hold(name, kernel, plain, results):
    """Runs ``kernel`` once (its launch count must rise by one) and holds
    it to ``plain``; records the max abs error."""
    import torch
    fn = wrappers()[name]
    before = fn.launches
    got = kernel()
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not rise")
    ref = plain()
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    err = float((got - ref).abs().max())
    peak = float(ref.abs().max())
    log(f"kernel {name}: max|kernel - plain| {err:.3e} (peak {peak:.3e}, "
        f"bound {KERNEL_RTOL * peak:.3e})")
    if not (np.isfinite(err) and err <= KERNEL_RTOL * peak):
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"{err:.3e} > {KERNEL_RTOL:g} * {peak:.3e}")
    res = results.setdefault(name, {"max_abs_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)


def time_pair(name, kernel, plain, results, work):
    """Times ``kernel`` and ``plain`` and records them with the bound of
    ``work`` = (bytes, operations)."""
    res = results[name]
    res["ms"] = cuda_ms(kernel)
    res["plain_ms"] = cuda_ms(plain)
    res["bound_ms"], res["bound_by"] = bound(*work)
    log(f"time {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {work[0]:.4e} B, {work[1]:.4e} flop)")


def kernel_phase(rng, points, dev):
    """Each 2D kernel against its plain version at the headline
    geometry."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

    plan = make_plan(PlanSpec("type_1", "forward", 2, (GRID, GRID),
                              "complex64", TOL, 1))
    geom, binned = bin_for_plan(torch.from_numpy(points).to(dev), plan)
    used = int(binned.tile_bounds[-1]) * geom.chunk
    log(f"plan: width {plan.width} sigma {plan.sigma} fine "
        f"{plan.fine_shape} horner terms {len(plan.horner)}; geometry: "
        f"tiles {geom.tiles} x {geom.tile} ext {geom.ext} chunk "
        f"{geom.chunk} chunks {geom.num_chunks} (used "
        f"{int(binned.tile_bounds[-1])})")
    kw = binning.build_weight_payload(binned, geom, plan)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    wrap = wrappers()
    results = {}
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
            hold(name, kernel, plain, results)
            if b2 == 2:
                work = tile_work(name.split("_")[0],
                                 name.endswith("_planned"), geom, plan, b2,
                                 NUM_POINTS, used)
                time_pair(name, kernel, plain, results, work)
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
    reset_launches()
    op1 = tnt.PlannedNufft(pts, grid, transform_type="type_1", tol=TOL)
    t1_planned = op1(strengths[None])[0]
    t1_unplanned = tnt.planar.nufft(strengths, pts, grid_shape=grid,
                                    transform_type="type_1", tol=TOL)
    op2 = tnt.PlannedNufft(pts, grid, transform_type="type_2", tol=TOL)
    t2_planned = op2(modes_p[None])[0]
    t2_unplanned = tnt.planar.nufft(modes_p, pts, transform_type="type_2",
                                    tol=TOL)
    torch.cuda.synchronize()
    launches = read_launches(2)

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


def transform_cases(op1, op2, pts, strengths, modes_p, grid, t2_kw):
    """The timed calls of a path: planned type-1 (op1) and type-2 (op2),
    the same two unplanned, and the plan build."""
    import tensorflow_nufft_tpu_torch as tnt
    src1, src2 = strengths[None], modes_p[None]
    return {
        "t1_planned": lambda: op1(src1),
        "t2_planned": lambda: op2(src2),
        "t1_unplanned": lambda: tnt.planar.nufft(
            strengths, pts, grid_shape=grid, transform_type="type_1",
            tol=TOL),
        "t2_unplanned": lambda: tnt.planar.nufft(
            modes_p, pts, transform_type="type_2", tol=TOL, **t2_kw),
        "plan_build": lambda: tnt.PlannedNufft(
            pts, grid, transform_type="type_1", tol=TOL),
    }


def transform_times(op1, op2, pts, strengths, modes_p):
    cases = transform_cases(op1, op2, pts, strengths, modes_p,
                            (GRID, GRID), {})
    times = {name: cuda_ms(cases[name]) for name in (
        "t1_planned", "t1_unplanned", "t2_planned", "t2_unplanned")}
    for name, ms in times.items():
        log(f"time {name}: {ms:.4f} ms per transform, "
            f"{NUM_POINTS / (ms * 1e-3):.4e} points/s")
    return times


def inputs3d():
    """bench_suite.py's 3D census inputs at seed 42: points, type-1
    strengths and type-2 modes."""
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-np.pi, np.pi, (NUM_POINTS3, 3)).astype(np.float32)
    z = (rng.standard_normal(NUM_POINTS3)
         + 1j * rng.standard_normal(NUM_POINTS3)).astype(np.complex64)
    modes = (rng.standard_normal(GRID3)
             + 1j * rng.standard_normal(GRID3)).astype(np.complex64)
    return points, z, modes


def kernel_phase_3d(points, dev):
    """Each rank-3 kernel against its plain version at the full 3D
    geometry (batch 1: two channels)."""
    import torch
    from tensorflow_nufft_tpu_torch.fft.planar_fft import _fft
    from tensorflow_nufft_tpu_torch.kernels import (binning, interp, mode3d,
                                                    spread)
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

    plan = make_plan(PlanSpec("type_1", "forward", 3, GRID3, "complex64",
                              TOL, 1))
    geom, binned = bin_for_plan(torch.from_numpy(points).to(dev), plan)
    got_geom = {k: getattr(geom, k) for k in GEOMETRY3}
    log(f"3D plan: width {plan.width} fine {plan.fine_shape}; geometry "
        f"{got_geom}; used chunks {int(binned.tile_bounds[-1])}")
    if got_geom != GEOMETRY3:
        raise RuntimeError(f"3D geometry {got_geom} != {GEOMETRY3}")
    kw = binning.build_weight_payload(binned, geom, plan)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    used = int(tb[-1]) * geom.chunk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values_pl = binning.build_values_payload(
        torch.randn((2, NUM_POINTS3), generator=gen, device=dev), binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    modes = torch.randn((1,) + GRID3 + (2,), generator=gen, device=dev)
    spec = _fft(mode3d.fold_plain(tiles, geom, 1), "forward")
    log(f"3D bytes: tile array {tiles.numel() * 4:.4e}, fine grid "
        f"{spec.numel() * 8:.4e}, planned windows "
        f"{kw.weights.numel() * 4:.4e} + starts {kw.starts.numel() * 4:.4e}, "
        f"coords payload {coords.numel() * 4:.4e}")
    wrap = wrappers()
    m, n3 = NUM_POINTS3, int(np.prod(GRID3))
    nf3 = int(np.prod(geom.fine_shape))
    tile_bytes = 4 * tiles.numel()
    cases = {
        "spread3d_planned": (
            lambda: wrap["spread3d_planned"](values_pl, tb, geom, plan, kw),
            lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                              kw=kw),
            tile_work("spread", True, geom, plan, 2, m, used)),
        "spread3d_unplanned": (
            lambda: wrap["spread3d_unplanned"](values_pl, tb, geom, plan,
                                               coords),
            lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                              coords=coords),
            tile_work("spread", False, geom, plan, 2, m, used)),
        "interp3d_planned": (
            lambda: wrap["interp3d_planned"](tiles, tb, geom, plan, kw),
            lambda: interp.interp_tiles_plain(tiles, tb, geom, plan, kw=kw),
            tile_work("interp", True, geom, plan, 2, m, used)),
        "interp3d_unplanned": (
            lambda: wrap["interp3d_unplanned"](tiles, tb, geom, plan,
                                               coords),
            lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                              coords=coords),
            tile_work("interp", False, geom, plan, 2, m, used)),
        # (bytes, operations): tiles in + grid out, one add per element.
        "fold3d": (
            lambda: wrap["fold3d"](tiles, geom, 1),
            lambda: mode3d.fold_plain(tiles, geom, 1),
            (tile_bytes + 8 * nf3, tiles.numel())),
        # The n^3 spectrum values it needs in, modes out, 4 multiplies.
        "truncate_deconvolve3d": (
            lambda: wrap["truncate_deconvolve3d"](spec, plan, geom),
            lambda: mode3d.truncate_deconvolve_plain(spec, plan),
            (16 * n3 + 4 * sum(GRID3), 4 * n3)),
        "amplify_pad3d": (
            lambda: wrap["amplify_pad3d"](modes, plan, geom),
            lambda: mode3d.amplify_pad_plain(modes, plan),
            (8 * n3 + 4 * sum(GRID3) + 8 * nf3, 4 * n3)),
        "extend_tiles3d": (
            lambda: wrap["extend_tiles3d"](spec, geom),
            lambda: mode3d.extend_plain(spec, geom),
            (8 * nf3 + tile_bytes, 0)),
    }
    results = {}
    for name, (kernel, plain, work) in cases.items():
        hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results, work)
    fine = spec.clone()
    for name, fn in (("fftn", lambda: torch.fft.fftn(fine, dim=(1, 2, 3))),
                     ("ifftn", lambda: torch.fft.ifftn(
                         fine, dim=(1, 2, 3), norm="forward"))):
        log(f"time torch.fft.{name} [1, 256^3] complex64: "
            f"{cuda_ms(fn):.4f} ms")
    return results


def plain_pipeline(source, points, plan):
    """The port's plain versions composed directly, with no dispatch: the
    reference pipelines of the 3D gates. Runs on the tensors' device (the
    card here), in their dtype."""
    from tensorflow_nufft_tpu_torch.fft.planar_fft import _fft
    from tensorflow_nufft_tpu_torch.kernels import (binning, interp, mode3d,
                                                    spread)
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    geom, binned = bin_for_plan(points, plan)
    kw = binning.build_weight_payload(binned, geom, plan)
    tb = binned.tile_bounds
    direction = plan.spec.fft_direction
    if plan.spec.transform_type == "type_1":
        values = binning.build_values_payload(source.t().contiguous(), binned)
        tiles = spread.spread_tiles_plain(values, tb, geom, plan, kw=kw)
        spec = _fft(mode3d.fold_plain(tiles, geom, 1), direction)
        return mode3d.truncate_deconvolve_plain(spec, plan)[0]
    fine = _fft(mode3d.amplify_pad_plain(source[None], plan), direction)
    tiles = mode3d.extend_plain(fine, geom)
    chunk_vals = interp.interp_tiles_plain(tiles, tb, geom, plan, kw=kw)
    flat = chunk_vals.transpose(0, 1).reshape(2, geom.num_slots)
    return binning.scatter_chunked(flat, binned).t()


def mode_freqs(flat, dev):
    """[S, 3] float64 frequencies k = i - n//2 of flat mode indices."""
    import torch
    half = torch.tensor([n // 2 for n in GRID3], device=dev)
    return (torch.stack(torch.unravel_index(flat, GRID3), dim=-1)
            - half).double()


def exact_type1_subset(points, z, idx, dev):
    """Forward type-1 NUDFT in complex128 at the flat mode indices
    ``idx``, summed over all points in chunks."""
    import torch
    k = mode_freqs(idx, dev)                                # [S, 3]
    x = torch.from_numpy(points).to(dev).double()
    c = torch.from_numpy(z).to(dev).to(torch.complex128)
    out = torch.zeros(len(idx), dtype=torch.complex128, device=dev)
    for lo in range(0, len(x), 8192):
        phase = x[lo:lo + 8192] @ k.T                       # [chunk, S]
        out += c[lo:lo + 8192] @ torch.polar(torch.ones_like(phase), -phase)
    return out


def exact_type2_subset(points, modes, idx, direction_sign, dev):
    """Type-2 NUDFT in complex128 at the points ``idx``, summed over all
    modes in chunks."""
    import torch
    x = torch.from_numpy(points).to(dev).double()[idx]     # [S, 3]
    f = torch.from_numpy(modes).to(dev).to(torch.complex128).reshape(-1)
    out = torch.zeros(len(idx), dtype=torch.complex128, device=dev)
    step = 16384
    for lo in range(0, f.numel(), step):
        k = mode_freqs(torch.arange(lo, min(lo + step, f.numel()),
                                    device=dev), dev)
        phase = direction_sign * (x @ k.T)                  # [S, chunk]
        out += torch.polar(torch.ones_like(phase), phase) @ f[lo:lo + step]
    return out


def end_to_end_3d(points, z, modes, dev):
    """The 3D main path at full size, with launch counting and the
    census gates."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

    pts = torch.from_numpy(points).to(dev)
    strengths = to_planar(z).to(dev)
    modes_p = to_planar(modes).to(dev)
    reset_launches()
    op1 = tnt.PlannedNufft(pts, GRID3, transform_type="type_1", tol=TOL)
    t1_planned = op1(strengths[None])[0]
    adj = op1.adjoint()                        # type-2, backward
    t2_planned = adj(modes_p[None])[0]
    t1_unplanned = tnt.planar.nufft(strengths, pts, grid_shape=GRID3,
                                    transform_type="type_1", tol=TOL)
    t2_unplanned = tnt.planar.nufft(modes_p, pts, transform_type="type_2",
                                    fft_direction="backward", tol=TOL)
    torch.cuda.synchronize()
    launches = read_launches(3)
    outs = {"t1_planned": t1_planned, "t1_unplanned": t1_unplanned,
            "t2_planned": t2_planned, "t2_unplanned": t2_unplanned}
    for name, out in outs.items():
        expect = GRID3 + (2,) if name.startswith("t1") else (NUM_POINTS3, 2)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"3D {name}: shape {tuple(out.shape)} (want "
                               f"{expect}) or non-finite values")
    log(f"3D planned vs unplanned max abs diff: type-1 "
        f"{float((t1_planned - t1_unplanned).abs().max()):.3e}, type-2 "
        f"{float((t2_planned - t2_unplanned).abs().max()):.3e}")

    sub = np.random.default_rng(SEED + 1)
    idx1 = torch.from_numpy(np.sort(sub.choice(
        int(np.prod(GRID3)), SUBSET, replace=False))).to(dev)
    idx2 = torch.from_numpy(np.sort(sub.choice(
        NUM_POINTS3, SUBSET, replace=False))).to(dev)
    exact = {"t1": exact_type1_subset(points, z, idx1, dev),
             "t2": exact_type2_subset(points, modes, idx2, 1.0, dev)}
    refs, floors = {}, {}
    for key, ttype, direction, src in (
            ("t1", "type_1", "forward", strengths),
            ("t2", "type_2", "backward", modes_p)):
        spec = dict(transform_type=ttype, fft_direction=direction, rank=3,
                    grid_shape=GRID3, tol=TOL, points_range=1)
        ref = from_planar(plain_pipeline(
            src.double(), pts.double(),
            make_plan(PlanSpec(dtype_name="complex128", **spec))))
        f32 = from_planar(plain_pipeline(
            src, pts, make_plan(PlanSpec(dtype_name="complex64", **spec))))
        scale = float(ref.abs().max())
        refs[key] = (ref, scale)
        floors[key] = float((f32.to(torch.complex128) - ref).abs().max()
                            / scale)
        log(f"3D {key}: floor_f32 (f32 vs f64 plain pipeline) "
            f"{floors[key]:.3e}; scale {scale:.6e}")
    gates, errors = [], {}
    for name, out in outs.items():
        key = name[:2]
        ref, scale = refs[key]
        got = from_planar(out).to(torch.complex128)
        idx = idx1 if key == "t1" else idx2
        err_total = float((got.reshape(-1)[idx] - exact[key]).abs().max()
                          / scale)
        err_impl = float((got - ref).abs().max() / scale)
        gate_impl = max(TOL, 4 * floors[key])
        errors[name] = (err_total, err_impl)
        log(f"3D {name}: err_total (vs exact NUDFT, {SUBSET} subset) "
            f"{err_total:.3e} (gate < {10 * TOL:g}); err_impl (vs f64 "
            f"plain pipeline) {err_impl:.3e} (gate < {gate_impl:.3e})")
        gates.append((name, err_total < 10 * TOL and err_impl < gate_impl))
    failed = [name for name, ok in gates if not ok]
    if failed:
        raise RuntimeError(f"3D accuracy gates failed: {failed}")
    return launches, op1, adj, pts, strengths, modes_p


def transform_times_3d(op1, adj, pts, strengths, modes_p):
    cases = transform_cases(op1, adj, pts, strengths, modes_p, GRID3,
                            dict(fft_direction="backward"))
    for name, fn in cases.items():
        ms = cuda_ms(fn)
        if name == "plan_build":
            log(f"time 3d plan build (PlannedNufft type-1): {ms:.4f} ms")
        else:
            log(f"time 3d_{name}: {ms:.4f} ms per transform, "
                f"{NUM_POINTS3 / (ms * 1e-3):.4e} points/s")


def profile_phase(label, cases, calls=20):
    """Event median, device busy time and idle share per call of each
    case (label -> zero-argument callable), with its largest device
    items."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, fn in cases.items():
        event_ms = cuda_ms(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        items = {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                items[evt.name] = (items.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us() / calls
                                   / 1e3)
        busy = sum(items.values())
        top = sorted(items.items(), key=lambda kv: -kv[1])[:4]
        log(f"profile {label} {name}: event median {event_ms:.4f} ms, "
            f"device busy {busy:.4f} ms, idle share "
            f"{1 - busy / event_ms:.3f}; largest: " + "; ".join(
                f"{k[:70]} {v:.4f} ms" for k, v in top))


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
    if "--profile" in sys.argv:
        profile_phase("2d", transform_cases(
            op1, op2, pts, strengths, modes_p, (GRID, GRID), {}))
    del op1, op2, pts, strengths, modes_p
    points3, z3, modes3 = inputs3d()
    results.update(kernel_phase_3d(points3, dev))
    torch.cuda.empty_cache()
    launches3, op1, adj, pts, strengths, modes_p = end_to_end_3d(
        points3, z3, modes3, dev)
    launches.update(launches3)
    transform_times_3d(op1, adj, pts, strengths, modes_p)
    if "--profile" in sys.argv:
        profile_phase("3d", transform_cases(
            op1, adj, pts, strengths, modes_p, GRID3,
            dict(fft_direction="backward")))
    kernels = []
    for name, (_, source, replaces, _) in KERNELS.items():
        res = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": _CSRC + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
