"""Smoke run of the PyTorch port (tensorflow_nufft_tpu_torch) on one GPU.

Drives the port's main paths (transforms and training) through the
entry points a user calls, on the card, with no JAX:

- 1D: 2^20 modes, 10^7 uniform points, tol 1e-6, seed 42 (non-uniform
  time series and 1D readouts at FINUFFT's 1D scale): fine grid 2^21,
  2048 tiles of ext 1032, chunk 256, 41,110 chunks; PlannedNufft takes
  the binned level (dense matrices of 4.3e10 B); the mats size is
  65,536 modes and 16,384 points;
- 2D: bench.py's headline, 256^2 modes, 65,536 uniform points, tol 1e-6,
  seed 42;
- per-batch and type-3: bench_suite.py's 2d_t2_256_200k_b16_perbatch
  (16 trajectories of 200,000 points at 256^2; phase 5d) and its three
  type-3 cells (phase 5e), at bench_suite's sizes;
- sharding (phase 5f): the JAX multichip dry run's calls at the CG-SENSE
  cell's width (128^2, 8 coils, 32,768 radial points) on a (2, 4) mesh
  of logical shards on this card, bench_suite's 2d_t3_200k_200k and the
  3D headline on 2 points shards;
- 3D: bench_suite.py's 3d_t1_128_800k / 3d_t2_128_800k, 128^3 modes,
  800,000 uniform points, tol 1e-6, seed 42, batch 1 (fine grid 256^3).
  The unplanned transforms tile it in 1024 tiles of ext (24, 24, 72),
  chunk 512, 2586 chunks; PlannedNufft takes the JAX package's binned
  level there (its dense matrices would exceed 256 MiB): z-ordered
  binning on 128 tiles of ext (136, 24, 72), 1690 chunks, an axis-0 band
  of 16 rows per 128-slot sub-chunk.

Phases:

1. Environment: torch, CUDA and nvcc versions, the card's name and power
   limit. Fails when torch sees no CUDA device.
2. Build: compiles the hand-written kernels (csrc/*.cu, nvcc, sm_90a) and
   prints each kernel's registers, static shared memory and spill bytes
   (-Xptxas -v).
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
5. 2D planned surface ("mats" level): with the counters zeroed,
   ``normal`` with and without ``slot_weights`` of a density vector (|k|)
   against ``adjoint()(forward(x))`` with the same weights, and
   ``apply_to_slots``/``apply_from_slots`` against ``to_slots``/
   ``from_slots`` of the point-order applies, to 1e-5 of the peak; times
   of ``normal`` against the composed pair.
5a. The native engine ("native"): builds ``cc/nufft_cpu.cc`` with g++
   (its seconds and OpenMP threads printed) and runs complex128 type-1
   and type-2 at the 2D headline through ``tnt.nufft`` with
   ``Options(backend="native")`` on CUDA tensors: the output on the card,
   no kernel launched, within 1e-10 of the peak of the card's float64
   route and 1e-12 of ``tnt.native.nufft`` on the same numpy data; the
   float32 planned type-1 and type-2 of the headline at err_impl < tol
   against the native complex128 result (bench.py's gate), printed
   beside their err_impl against the port's float64 plain pipeline (the
   two references within 1e-9 of each other); the native calls' host
   times.
5b. The complex API ("complex2d"): with the counters zeroed, complex64
   ``nufft`` type-1 and type-2 in both directions, ``interp`` and
   ``spread`` on the 512^2 grid and a training step (x [8, 256, 256]
   complex and k learnable, a type-2 loss plus an interp loss,
   ``loss.backward()``); the kernels of TPU rows 2, 6, 11 and 11' must
   launch. Each output against the planar API on the same data (bit for
   bit, else within 1e-6 of the peak), the gradients within 1e-6 of the
   peak; the transforms against the exact NUDFT (< 10 * tol) and the
   complex128 transforms on the card (the float64 route, err_impl <
   tol); the complex128 transforms at tol 1e-6 (< 10 * tol) and 1e-12
   (4096-element subsets, < 1e-10), during which no kernel launches.
5c. CG-SENSE ("cg_sense") at bench_suite.py's cell (128^2, 8 coils, 128
   spokes x 256 samples, ramp density, Shepp-Logan, 10 iterations,
   float32): the composed operator (the plan's ``normal``, "mats")
   launching one planned spread and interp per iteration and one spread
   for the right-hand side, the Toeplitz one launching that spread only;
   each within 2e-3 of the peak of a complex128 CG-SENSE on the card
   (level "none", no launch), the Toeplitz one of the composed one;
   Pipe-Menon weights (finite, sum 1, the card's within 1e-4 of the same
   float32 weights on the CPU, within max(1e-4, 4 * floor_f32) of the
   float64 ones); times of both reconstructions and both builds.
5d. Per-batch trajectories ("perbatch", bench_suite.py's
   2d_t2_256_200k_b16_perbatch: default_rng(7), 16 trajectories of
   200,000 points, 16 images of 256^2, tol 1e-6) through
   planar.BatchedPlannedNufft: every shard at the "binned" level (its
   MATS_BYTES_BUDGET // 16 share), so one type-2 apply and one apply of
   the adjoint batch launch the unbanded interp and spread 16 times
   each. Both outputs equal the loop of single plans bit for bit; on
   trajectories 0 and 15 err_total < 10 * tol (exact NUDFT, 4096-element
   subsets) and err_impl < tol (float64 route); the backward is the
   adjoint batch; an inner batch axis equals two applies; the two
   kernels held to their plain versions at a shard's geometry; times.
5e. Type-3 ("type3", bench_suite.py's 2d_t3_200k_200k, 3d_t3_500k_500k
   and 3d_t3_500k_500k_unplanned: default_rng(7), M = K = 200,000 at
   t_range 64 and 500,000 at 16, tol 1e-6) through planar.Type3Plan and
   planar.nufft_type3: each stage's level and geometry printed, one apply
   counted (the outer spread, the 3D fold, the inner interp and at 3D
   its mode stage); gates against the float32 plain pipeline (< 10 *
   tol), the exact type-3 NUDFT on 4096 targets and the complex128
   Type3Plan (the float64 route, no launch) at the floor rule of phase
   7, complex64 Type3Plan within the same gates, the adjoint identity
   (1e-5) and the backward equal to adjoint() bit for bit; each stage
   kernel held to its plain version at the cell's geometry; times.
5f. Sharding ("sharded"): the calls of the JAX package's multichip dry
   run (``__graft_entry__._dryrun_impl``) through ``tnt.parallel`` at the
   CG-SENSE cell's width on a (2, 4) ("data", "points") mesh repeating
   this card (one process drives the 8 logical shards, in turn):
   sharded_nufft type-2 and its loss gradient, type-1,
   sharded_nufft_grid type-1 and type-2, ShardedPlannedNufft type-2,
   normal, the planned loss gradient and the slot surface;
   sharded_nufft_type3 at 2d_t3_200k_200k (batch 2); the 3D headline
   through ShardedPlannedNufft on 2 points shards of 400,000 (binned,
   uniform band). Each call counted alone (its blocks' launches, exactly);
   outputs and gradients within 1e-5 of the peak of the unsharded port
   calls and err_total < 10 * tol against exact NUDFTs; CUDA-event times
   beside the unsharded calls (the cost of single-controller dispatch on
   one card, not scaling).
5g. bench_suite.py's remaining cells and the ported paths no earlier
   phase runs ("suite"), each through the entry points a user calls, at
   bench_suite's sizes and seeds (default_rng(7), tol 1e-6):
   2d_t1_256_200k and 2d_t{2,1}_256_200k_b16_shared (PlannedNufft,
   "mats", B2 2 and 32); 3d_t1_128_1m (PlannedNufft type-1, the banded
   level or its re-plan, printed); 2d_t2_512_radial_b8 and its _slots
   form (models.mri.radial_trajectory(512, 1024), 8 coils, "binned");
   trajectory learning on those radial points (x [8, 512, 512, 2] and k
   learnable); 2d_t1_512_20m_bigm (unplanned planar.nufft, 20,000,000
   points, 20,523,008 slots, past 2^24); the 3D ToeplitzNormal at the 3D
   headline (weighted); the float64 route at 3D (complex128 tnt.nufft at
   tol 1e-6, and at 1e-12 on 100,000 points). Gates: the census rule of
   phase 7 (floor_gates) against exact NUDFTs on 4096-element subsets
   (1024 modes at 20M points) and the card's float64 route; the slots
   form equal to to_slots of the point-order apply within 1e-5 of the
   peak; the radial points gradient within 1e-4 of a float64 central
   difference, both gradients held to the float64 plain pipeline and the
   float64 route's; the float32 Toeplitz apply held to the float64
   route's and to PlannedNufft.normal under the floor rule, floor_f32
   being the float32 XLA path's; the float64 calls launch no kernel.
   Each cell prints its level, geometry, launches, CUDA-event median,
   peak memory and the card's name and power limit; the cells' launches
   add to the JSON line's counts.
6. 3D kernels: at the unbanded 3D geometry, the unplanned spread and
   interp, fold3d and extend_tiles3d against their plain versions on
   the card, with the same 1e-5 bound; the per-slot-window kernels there
   (the planned route at the "mats" level) held and timed for
   comparison. The halo kernels (extend_tiles3d, fold3d) also repeated
   bit for bit and timed beside the one PyTorch call that computes the
   same function (the library time: torch.take of the grid's float32
   view for extend, a zero fill and index_add_ for fold, with int64
   indices built outside the timed call; the port never calls them).
   The mode stages on the FFT kernel (csrc/fft3d.cu: three pruned
   passes, the amplification and padding in the first load of
   modes_to_fine, the truncation and deconvolution in the last store of
   fine_to_modes) at batch 1 and 3 against their plain versions
   (amplify_pad_plain or truncate_deconvolve_plain around torch.fft: the
   cuFFT route) within 2e-6 of the peak, repeated bit for bit, timed
   beside them with two bounds (the stage's input and output once; the
   bytes its passes move). The FFT kernel's full-grid mode (fft3d_cuda,
   on no path of the port) against torch.fft on the 256^3 grid in both
   directions, within 2e-6 of the peak, repeated bit for bit and timed
   beside it (torch.fft is both its plain version and its library
   call); again on the fused route's [1, 256, 256, 128] (two axes) and
   the large-tile cell's 320^3 grid, with the stages there.
7. 3D end to end: zeroes the counters, runs PlannedNufft type-1 (the
   binned level: the banded spread and the staged mode stage) and its
   adjoint() (the banded interp), then planar.nufft type-1 and type-2,
   and checks that every kernel of those routes was launched; prints the
   plan's geometry, slot count and band. Gates, as bench_suite.py's 3D
   census: err_total < 10 * tol against the exact NUDFT in complex128 on
   a seeded subset (4096 modes over all points for type-1, 4096 points
   over all modes for type-2), and err_impl < max(tol, 4 * floor_f32)
   against the port's float64 plain pipeline, where floor_f32 is the
   port's float32 plain pipeline's error against that same float64 one
   (both plain pipelines run on the card, called directly, not through
   dispatch). Then ("complex3d") the complex API's complex64 type-1
   and type-2 at the headline, launching the kernels of rows 4, 11 and
   14-19, each equal to the planar API's.
8. 3D binned kernels: at the binned geometry, the banded spread at B2 =
   2 (row 7), at 4 and with slot-order values (row 8), the banded interp
   (row 13, its chunk- and point-order outputs), the fused spread with
   its axis-2 epilogue (row 9) against its plain version (1e-5 of the
   peak) and the pruned passes of axes 1 and 0 after its two-axis fold
   (fine_to_modes2) as in phase 6, each timed; the
   banded spread and interp repeated bit for bit; extend_tiles3d, fold3d
   and fold2 at this geometry as in phase 6 (held, repeated, timed with
   their library calls).
9. 3D planned surface at the binned level: as phase 5 on the adjoint
   (type-2) plan, with launch counts.
10. The type-1 routes: the fused and the staged route held to each other
   and timed in turns (the port's gate, planar_fft.FUSED_DFTA, is set
   from these times); then the fused route with launch counting, as a
   caller who turns the gate on runs it (type-1 and normal).
11. Times (CUDA events, median of 25 runs after warm-up; plain versions
   5): each kernel and its plain version, the 2D and 3D transforms
   (points/s), the two 3D torch.fft calls and the 3D plan build, and the
   3D planned transforms and plan build on the "mats" route (per-slot
   windows on the unbanded geometry, the budget raised) on the same card,
   the planned transforms of the two routes in turns (binned, mats, mats,
   binned). Each kernel's bound is
   the larger of its bytes over 3.35 TB/s and its float32 operations
   over 67 TFLOP/s (H100 SXM data sheet), from this run's shapes.
12. 3D planned at a mats-level size (128^3 modes, 200,000 points, where
   the JAX plan keeps its dense matrices and runs TPU rows 3 and 12):
   a planned type-1 and its adjoint with launch counting, held to the
   unplanned transforms; the planned spread and interp held and timed.
13. Large extended tiles (larger than one thread block's shared
   memory): unplanned planar.nufft type-1 and type-2 at 3D 256^3 modes
   on the 3D headline's 800,000 points (fine grid 320^3, sigma 1.25,
   width 10, 2000 tiles of ext (32, 32, 80)), then at 2D 150^2 on the 2D
   headline's points (one tile of ext (308, 308)); launch counts of
   each. Gates: err_total (complex128 NUDFT; 3D on 4096-element subsets)
   below 10 * tol and err_impl (the float64 plain pipeline) below tol,
   or, where the port's float32 plain pipeline of the same plan does not
   reach those (its float32 floor: sigma 1.25 in 3D, the tile-origin
   kernel argument of one 308-wide tile in 2D), below 4x that
   pipeline's own errors, the census rule of phase 7 applied to both.
   Then the spread and interp kernels held to their plain versions at
   both geometries and timed, and the halo kernels, the mode stages and
   the full-grid FFT at the 3D one as in phase 6.
13b. Long fine axes ("3d_long"): 3D modes (8, 8, 4096) and (4096, 8, 8)
   on 65,536 seeded points, tol 1e-6 (fine grids (16, 16, 8192) and
   (8192, 16, 16): a line longer than one block's shared memory, which
   the FFT kernel splits in two launches), unplanned planar.nufft
   type-1 and type-2 and PlannedNufft type-1 and its adjoint, with
   launch counts, gated as phase 7.
14. Training kernels: the derivative interp (phi' on one axis) on each
   axis at the 2D headline and on axis 0 at the 3D headline, and the
   unplanned spread at 6, 16 and 32 channels (2D) and 6 (3D), against
   their plain versions, timed.
15. 2D training: the headline points as a learnable [65536, 2] tensor
   and a multicoil image x [8, 256, 256, 2]; loss 0.5 |A(x; k) - y|^2
   with A the type-2 NUFFT and y made with a perturbed trajectory.
   Step-1 gradients gated: err_total < 10 * tol against complex128
   NUDFTs of the same formulas (x.grad on all modes, k.grad on a seeded
   4096-point subset) and err_impl < max(tol, 4 * floor_f32) against
   the float64 plain pipeline on the card; the planned form (x only,
   through adjoint()); three Adam steps whose loss must fall; one
   type-1-loss step (batch 3); launch counts and times per step.
16. 2D spread-only: planar.interp and planar.spread on the 512^2 fine
   grid, forward and backward, against the same calls on CPU tensors,
   and the points gradient against a float64 central difference of the
   plain ops at a few points.
17. 3D training: one forward + backward of the type-2 loss at the 3D
   headline (batch 1), gated on 4096-element subsets, timed; then the
   3D spread-only ops as in 16, without the CPU comparison.
18. 1D kernels at the 1D headline geometry (B2 = 2): the rank-1 spread
   (from point-order and from slot-order values), interp and phi'
   interp against their plain versions (1e-5 of the peak), each
   repeated bit for bit, timed with their bounds; the spread and interp
   also at B2 = 8 (the type-2 training step's channels).
19. 1D end to end at the headline: PlannedNufft type-1 (binned level)
   and its adjoint, planar.nufft type-1 and type-2, with launch counts
   and no call of a plain version on the card path; gates err_total
   against complex128 NUDFTs on 4096-element subsets and err_impl
   against the float64 plain pipeline, at the bare gates where the
   float32 plain pipeline reaches them, else at 4x its own errors
   (phase 13's rule); reports the tile-0 binade crossing of the kernel
   argument; times each transform (CUDA events); then the binned
   level's planned surface as in phase 5.
20. 1D mats size (65,536 modes, 16,384 points): asserts the "mats"
   level; planned type-1, adjoint and unplanned type-1 with launch
   counts, held to the unplanned transforms; the planned surface at the
   mats level and at the binned level of the same size (budget
   lowered); the planned spread and interp, the unplanned spread and the
   slot-order spread held to their plain versions, repeated, timed.
21. 1D training at the headline points: a type-2 loss step with x [4,
   2^20, 2] and k [10^7, 1] learnable, gated as phase 17; a batch-3
   type-1 loss step gated on err_impl; launch counts per step, no plain
   version on the card path; the 1D spread-only ops with the finite
   difference gate of phase 16 (its step scaled to the same fraction of
   a fine-grid cell).

With --profile: for each transform, plan build and training step, the
CUDA-event median, the device busy time per call from torch.profiler
(the sum of the device activities of 20 calls, / 20), the idle share
1 - busy / event time, and the largest device items. The stage-span
phase runs before the first of these readings, right after phase 5.

Every main path's launch count is read with the rank-3 calls of
torch.fft on the card: the run fails if one ran (a fallback).

Before the JSON, each rewritten spread and interp kernel's time is
printed beside the block-per-tile kernel's that PERF.md records, and
each rank-1 kernel's beside that of the two-kernel rank-1 design it
replaced, with its bound and its launches. Prints the kernels as one
JSON line, then the nvidia-smi line, then, last,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.

Usage: python3 chip_smoke.py [--profile]
"""

import contextlib
import functools
import json
import pathlib
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
# The FFT kernel against torch.fft (both float32 FFTs), of the peak.
FFT_RTOL = 2e-6
WARMUP = 3
REPS = 25
# Where the spans phase's profiling.trace writes (build/ is ignored by
# git).
TRACE_DIR = str(pathlib.Path(__file__).resolve().parent / "build"
                / "torch_traces")
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


def rel(got, ref, scale=None):
    """max |got - ref| / (scale or max |ref|), in float64 (complex128 for
    complex tensors)."""
    import torch
    dtype = (torch.complex128 if got.is_complex() or ref.is_complex()
             else torch.float64)
    got, ref = got.to(dtype), ref.to(dtype)
    scale = float(ref.abs().max()) if scale is None else scale
    return float((got - ref).abs().max()) / scale


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
    for name, regs, smem, spills in ptxas_kernels(_build.BuildInfo.log):
        log(f"  ptxas {name}: {regs} registers, {smem} bytes static smem, "
            f"spills {spills}")


def ptxas_kernels(text):
    """(kernel, registers, static shared bytes, "stores/loads" spill
    bytes) per entry function of nvcc's ``-Xptxas -v`` output, names
    demangled with c++filt where the machine has it."""
    import re
    out, name, spills = [], None, "0/0"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "0/0"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append([name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0, spills])
            name = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(k[0] for k in out),
            capture_output=True, text=True, check=True).stdout.split("\n")
        for k, demangled in zip(out, names):
            k[0] = demangled.replace("(anonymous namespace)::", "")
            k[0] = k[0].split("(")[0] if "(" in k[0] else k[0]
    except (OSError, subprocess.CalledProcessError):
        pass
    return [tuple(k) for k in out]


_PS = "tensorflow_nufft_tpu/kernels/pallas_spread.py"
_PI = "tensorflow_nufft_tpu/kernels/pallas_interp.py"
_PD = "tensorflow_nufft_tpu/kernels/pallas_dft.py"
_CSRC = "tensorflow_nufft_tpu_torch/csrc/"
KERNELS = {
    # name: (wrapper, source, TPU kernel it replaces, the main-path phase
    # whose launch count the JSON reports)
    "spread_planned": ("spread.spread_planned_cuda", "spread.cu",
                       f"{_PS}:518", "2d"),
    "spread_unplanned": ("spread.spread_unplanned_cuda", "spread.cu",
                         f"{_PS}:582", "2d"),
    "interp_planned": ("interp.interp_planned_cuda", "interp.cu",
                       f"{_PI}:152", "2d"),
    "interp_unplanned": ("interp.interp_unplanned_cuda", "interp.cu",
                         f"{_PI}:218", "2d"),
    # At the 3D headline the JAX PlannedNufft takes its binned level: its
    # dense kernel matrices (6.36e8 B) exceed their 256 MiB budget. It then
    # bins in z-order on a coarse axis-0 geometry and runs the
    # axis-0-banded kernels, as the port's plan does: rows 7 and 13 (8
    # with slot-order values or B2 > 2), and row 9 (the fused axis-2
    # epilogue, followed by passes B and C) where its gate takes it.
    # The planned type-1 takes the staged route by default (banded spread,
    # fold3d, the pruned FFT passes with the truncation); "3d_fused" runs
    # the fused route with the gate turned on.
    "spread3d_banded": ("spread.spread_banded_cuda", "spread.cu",
                        f"{_PS}:693", "3d"),
    "spread3d_banded_split": ("spread.spread_banded_cuda", "spread.cu",
                              f"{_PS}:736", "3d_slots"),
    "spread3d_dfta": ("spread.spread_dfta_cuda", "spread.cu", f"{_PS}:786",
                      "3d_fused"),
    "fold2": ("mode3d.fold2_cuda", "mode3d.cu", f"{_PD}:362,384",
              "3d_fused"),
    # The fused route's passes of axes 1 and 0, the truncation and the
    # weights of axes 0 and 1 in the last store.
    "fine_to_modes2": ("fft3d.fine_to_modes_cuda", "fft3d.cu",
                       f"{_PD}:362,384", "3d_fused"),
    "interp3d_banded": ("interp.interp_banded_cuda", "interp.cu",
                        f"{_PI}:281", "3d"),
    "spread3d_unplanned": ("spread.spread_unplanned_cuda", "spread.cu",
                           f"{_PS}:638", "3d"),
    "interp3d_unplanned": ("interp.interp_unplanned_cuda", "interp.cu",
                           f"{_PI}:218", "3d"),
    "fold3d": ("mode3d.fold3d_cuda", "mode3d.cu", f"{_PD}:346,362,384", "3d"),
    "extend_tiles3d": ("mode3d.extend_tiles3d_cuda", "mode3d.cu",
                       f"{_PD}:222,246,261", "3d"),
    # The six pass kernels' DFTs (their twiddle-matrix products): a
    # mixed-radix FFT, one pruned launch per axis (two for a line longer
    # than shared memory), with the amplification and padding in the
    # type-2 chain's first load and the truncation and deconvolution in
    # the type-1 chain's last store.
    "modes_to_fine": ("fft3d.modes_to_fine_cuda", "fft3d.cu",
                      f"{_PD}:222,246,261", "3d"),
    "fine_to_modes": ("fft3d.fine_to_modes_cuda", "fft3d.cu",
                      f"{_PD}:346,362,384", "3d"),
    # Training. The JAX plan spreads 2 * rank + B2 > 8 channels with its
    # split-payload kernels: the resident one at the 2D headline for B2 =
    # 6 (a batch-3 type-1 loss), the per-tile one for B2 = 16 (the source
    # gradient of a batch-8 type-2 loss, in groups of 8). The spread-only
    # ops' points gradients run _interp_kernel with its deriv_axis flag.
    "spread_split_resident": ("spread.spread_unplanned_cuda", "spread.cu",
                              f"{_PS}:898", "train2d_type1"),
    "spread_split": ("spread.spread_unplanned_cuda", "spread.cu",
                     f"{_PS}:956", "train2d"),
    "interp_deriv": ("interp.interp_deriv_cuda", "interp.cu",
                     f"{_PI}:218 (deriv_axis)", "spread_only_2d"),
    "interp3d_deriv": ("interp.interp_deriv_cuda", "interp.cu",
                       f"{_PI}:218 (deriv_axis)", "spread_only_3d"),
    # At 128^3 modes and 200,000 points the JAX plan keeps its dense
    # matrices (2.218e8 B) and runs the per-tile-grid mats kernels.
    "spread3d_planned_mats": ("spread.spread_planned_cuda", "spread.cu",
                              f"{_PS}:1011", "planned3d_mats"),
    "interp3d_planned_mats": ("interp.interp_planned_cuda", "interp.cu",
                              f"{_PI}:373", "planned3d_mats"),
    # Extended tiles larger than one thread block's shared memory, through
    # the unplanned transforms: 3D 256^3 modes at the 3D headline's points
    # (width 10, ext (32, 32, 80)) and 2D 150^2 (one tile of ext (308,
    # 308)).
    "spread3d_unplanned_large": ("spread.spread_unplanned_cuda", "spread.cu",
                                 f"{_PS}:638", "large3d"),
    "interp3d_unplanned_large": ("interp.interp_unplanned_cuda", "interp.cu",
                                 f"{_PI}:218", "large3d"),
    "spread2d_unplanned_large": ("spread.spread_unplanned_cuda", "spread.cu",
                                 f"{_PS}:582", "large2d"),
    "interp2d_unplanned_large": ("interp.interp_unplanned_cuda", "interp.cu",
                                 f"{_PI}:218", "large2d"),
    # Rank 1. The rank-1 branches of the TPU kernels (chunk_contribution,
    # chunk_interp_values) run in whichever kernel the JAX dispatcher
    # picks at a shape. At the 1D headline (2^20 modes, 10^7 points) the
    # tile array (16.9 MB at B2 = 2) exceeds its 12 MiB residence budget,
    # so unplanned and binned-level spreads take the per-tile-grid
    # _spread_kernel (combined payload: 2 * rank + B2 <= 8 in its channel
    # groups of 6, the training steps too), slot-order values the
    # per-tile split one; at the mats size (65,536 modes, 16,384 points)
    # the tile array stays resident: rows 1, 2 and, with slot-order
    # values at the binned level, 5.
    "spread_unplanned_1d": ("spread.spread_unplanned_cuda", "spread.cu",
                            f"{_PS}:638", "1d"),
    "spread_split_1d": ("spread.spread_unplanned_cuda", "spread.cu",
                        f"{_PS}:956", "1d_slots"),
    "interp_unplanned_1d": ("interp.interp_unplanned_cuda", "interp.cu",
                            f"{_PI}:218", "1d"),
    "interp_deriv_1d": ("interp.interp_deriv_cuda", "interp.cu",
                        f"{_PI}:218 (deriv_axis)", "spread_only_1d"),
    "spread_planned_1d": ("spread.spread_planned_cuda", "spread.cu",
                          f"{_PS}:518", "1d_mats"),
    "interp_planned_1d": ("interp.interp_planned_cuda", "interp.cu",
                          f"{_PI}:152", "1d_mats"),
    "spread_resident_1d": ("spread.spread_unplanned_cuda", "spread.cu",
                           f"{_PS}:582", "1d_mats"),
    "spread_split_resident_1d": ("spread.spread_unplanned_cuda",
                                 "spread.cu", f"{_PS}:898",
                                 "1d_binned_slots"),
    # B2 = 8 at the 1D headline: the type-2 training step's forward and
    # points-gradient interps (batch 4) and its source gradient's spread.
    "spread_unplanned_1d_b8": ("spread.spread_unplanned_cuda", "spread.cu",
                               f"{_PS}:638", "train1d"),
    "interp_unplanned_1d_b8": ("interp.interp_unplanned_cuda", "interp.cu",
                               f"{_PI}:218", "train1d"),
    # The per-batch cell (16 trajectories of 200,000 points at 256^2):
    # each shard's dense matrices (1.9e8 B) exceed its 16 MiB share, so
    # the JAX shards stream coords; their 512^2 tile array stays resident
    # (rows 2 and 11), the port's rank-2 "binned" level.
    "spread2d_binned_perbatch": ("spread.spread_unplanned_cuda",
                                 "spread.cu", f"{_PS}:582", "perbatch"),
    "interp2d_binned_perbatch": ("interp.interp_unplanned_cuda",
                                 "interp.cu", f"{_PI}:218", "perbatch"),
    # Type-3. 2D (200k -> 200k, fine 288^2, inner 576^2): both stages'
    # matrices (1.8e8 + 2.1e8 B) exceed the shared budget, so the outer
    # spread streams coords (resident: row 2) and the inner type-2 keeps
    # its matrices (resident: row 10). 3D (500k -> 500k, fine 72^3, inner
    # 144^3): the inner type-2 (3.1e8 B) does not fit alone, so the
    # outer spread keeps its matrices (per tile: row 3) and the inner
    # one takes the banded binned level (row 13, band 12), with the
    # outer fold (row 17) and the inner mode stage (rows 14-16).
    "spread_t3_2d": ("spread.spread_unplanned_cuda", "spread.cu",
                     f"{_PS}:582", "type3_2d"),
    "interp_t3_2d": ("interp.interp_planned_cuda", "interp.cu",
                     f"{_PI}:152", "type3_2d"),
    "spread_t3_3d": ("spread.spread_planned_cuda", "spread.cu",
                     f"{_PS}:1011", "type3_3d"),
    "fold3d_t3": ("mode3d.fold3d_cuda", "mode3d.cu", f"{_PD}:346,362,384",
                  "type3_3d"),
    "interp_t3_3d": ("interp.interp_banded_cuda", "interp_banded.cu",
                     f"{_PI}:281", "type3_3d"),
    "modes_to_fine_t3": ("fft3d.modes_to_fine_cuda", "fft3d.cu",
                         f"{_PD}:222,246,261", "type3_3d"),
    "extend_tiles3d_t3": ("mode3d.extend_tiles3d_cuda", "mode3d.cu",
                          f"{_PD}:222,246,261", "type3_3d"),
}
# Wrapper times of the block-per-tile spread and interp kernels that the
# row-slab kernels replaced, at the same shapes, as PERF.md section 6
# records them (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's;
# the large-tile rows have none (those kernels did not launch there).
PARENT_MS = {
    "spread_planned": 0.4451, "spread_unplanned": 0.5215,
    "spread3d_planned_mats": 1.1505, "spread3d_unplanned": 5.2645,
    "spread_split_resident": 0.4976, "spread_split": 0.6004,
    "interp_planned": 0.1292, "interp_unplanned": 0.1372,
    "interp3d_unplanned": 2.6644, "interp_deriv": 0.1386,
    "interp3d_deriv": 2.6061, "interp3d_planned_mats": 1.5040,
}
# Wrapper times of the rank-1 kernels the current ones replaced (a
# windows kernel writing every slot's window, then a spread walking the
# tile's starts in device memory; an interp block per channel), as
# PERF.md section 6 records them (NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's; None where that design was not timed at the shape.
# tools/torch_line_probe.py times two trees in turns in one call.
TWO_KERNEL_MS = {
    "spread_unplanned_1d": 1.7003, "spread_split_1d": 1.7168,
    "interp_unplanned_1d": 1.4174, "interp_deriv_1d": 0.8510,
    "spread_planned_1d": 0.0632, "interp_planned_1d": 0.0721,
    "spread_resident_1d": 0.1147, "spread_split_resident_1d": 0.1001,
    "spread_unplanned_1d_b8": None, "interp_unplanned_1d_b8": None,
}
# Kernels each main-path phase must launch (one entry per wrapper).
PHASE_KERNELS = {
    "2d": ("spread_planned", "spread_unplanned", "interp_planned",
           "interp_unplanned"),
    "2d_slots": ("spread_planned", "interp_planned"),
    "3d": ("spread3d_banded", "spread3d_unplanned", "interp3d_banded",
           "interp3d_unplanned", "fold3d", "fine_to_modes", "modes_to_fine",
           "extend_tiles3d"),
    "3d_slots": ("spread3d_banded_split", "interp3d_banded", "fold3d",
                 "fine_to_modes", "modes_to_fine", "extend_tiles3d"),
    "3d_fused": ("spread3d_dfta", "fold2", "fine_to_modes2",
                 "interp3d_banded", "modes_to_fine", "extend_tiles3d"),
    "3d_long": ("spread3d_unplanned", "interp3d_unplanned", "fold3d",
                "fine_to_modes", "modes_to_fine", "extend_tiles3d"),
    "train2d": ("spread_split", "interp_unplanned"),
    "train2d_planned": ("spread_planned", "interp_planned"),
    "train2d_type1": ("spread_split_resident", "interp_unplanned"),
    "train3d": ("spread3d_unplanned", "interp3d_unplanned", "fold3d",
                "fine_to_modes", "modes_to_fine", "extend_tiles3d"),
    "spread_only_2d": ("spread_unplanned", "interp_unplanned",
                       "interp_deriv"),
    "spread_only_3d": ("spread3d_unplanned", "interp3d_unplanned",
                       "extend_tiles3d", "fold3d", "interp3d_deriv"),
    "planned3d_mats": ("spread3d_planned_mats", "interp3d_planned_mats",
                       "fold3d", "fine_to_modes", "modes_to_fine",
                       "extend_tiles3d"),
    "large3d": ("spread3d_unplanned_large", "interp3d_unplanned_large",
                "fold3d", "fine_to_modes", "modes_to_fine",
                "extend_tiles3d"),
    "large2d": ("spread2d_unplanned_large", "interp2d_unplanned_large"),
    "1d": ("spread_unplanned_1d", "interp_unplanned_1d"),
    "1d_slots": ("spread_split_1d", "interp_unplanned_1d"),
    "1d_mats": ("spread_planned_1d", "interp_planned_1d",
                "spread_resident_1d"),
    "1d_mats_slots": ("spread_planned_1d", "interp_planned_1d"),
    "1d_binned_slots": ("spread_split_resident_1d", "interp_unplanned_1d"),
    "train1d": ("spread_unplanned_1d", "interp_unplanned_1d",
                "spread_unplanned_1d_b8", "interp_unplanned_1d_b8"),
    "train1d_type1": ("spread_unplanned_1d", "interp_unplanned_1d"),
    "spread_only_1d": ("spread_unplanned_1d", "interp_unplanned_1d",
                       "interp_deriv_1d"),
    # The complex API: its complex64 transforms, spread-only ops and
    # a training step at the 2D headline (rows 2, 6, 11, 11'), its
    # transforms at the 3D headline (rows 4, 11, 14-19), and CG-SENSE on
    # the planned 2D pair (rows 1, 10).
    "complex2d": ("spread_unplanned", "spread_split", "interp_unplanned",
                  "interp_deriv"),
    "complex3d": ("spread3d_unplanned", "interp3d_unplanned", "fold3d",
                  "fine_to_modes", "modes_to_fine", "extend_tiles3d"),
    "cg_sense": ("spread_planned", "interp_planned"),
    # The per-batch cell (one apply and one adjoint apply: 16 launches
    # each) and the type-3 cells (one apply each).
    "perbatch": ("spread2d_binned_perbatch", "interp2d_binned_perbatch"),
    "type3_2d": ("spread_t3_2d", "interp_t3_2d"),
    "type3_3d": ("spread_t3_3d", "fold3d_t3", "interp_t3_3d",
                 "modes_to_fine_t3", "extend_tiles3d_t3"),
    "type3_3d_unplanned": ("spread_t3_3d", "fold3d_t3", "interp_t3_3d",
                           "modes_to_fine_t3", "extend_tiles3d_t3"),
    # The suite phase's cells at bench_suite.py's sizes (rows 1, 2, 4, 6,
    # 7, 10, 11 and the 3D type-1 mode stage). Their counts add to the
    # JSON's launches of the kernels they run. The 1M-point plan takes the
    # banded level, or re-plans onto the unbanded geometry where the band
    # degenerates; the radial plan is "binned" (coords, the unbanded
    # kernels); the Toeplitz build spreads onto 256^3 (sigma 1.25).
    "suite_2d_t1_256_200k": ("spread_planned",),
    "suite_2d_t2_256_200k_b16_shared": ("interp_planned",),
    "suite_2d_t1_256_200k_b16_shared": ("spread_planned",),
    "suite_3d_t1_128_1m": ("spread3d_banded", "fold3d", "fine_to_modes"),
    "suite_3d_t1_128_1m_unbanded": ("spread3d_unplanned", "fold3d",
                                    "fine_to_modes"),
    "suite_2d_t2_512_radial_b8": ("interp_unplanned",),
    "suite_2d_t2_512_radial_b8_slots": ("interp_unplanned",),
    "suite_radial_grad": ("spread_split", "interp_unplanned"),
    "suite_2d_t1_512_20m_bigm": ("spread_unplanned",),
    "suite_toeplitz3d": ("spread3d_unplanned", "fold3d", "fine_to_modes"),
}


def wrappers():
    """Kernel name -> its CUDA wrapper (which holds the launch count)."""
    from tensorflow_nufft_tpu_torch.kernels import (fft3d, interp, mode3d,
                                                    spread)
    modules = {"spread": spread, "interp": interp, "mode3d": mode3d,
               "fft3d": fft3d}
    out = {}
    for name, (path, _, _, _) in KERNELS.items():
        module, fn = path.split(".")
        out[name] = getattr(modules[module], fn)
    return out


# Calls of the FFT's plain version (torch.fft) on a rank-3 grid on the
# card since the last reset_launches(): the 3D mode stages run the FFT
# kernel there, so any such call is a fallback.
_CARD_FFT_PLAIN = [0]


def count_card_fft_plain():
    """Wraps ``fft3d.fft_plain`` (which the mode stages reach through
    their module) so that each call on a rank-3 grid on the card is
    counted in ``_CARD_FFT_PLAIN``."""
    from tensorflow_nufft_tpu_torch.kernels import fft3d
    plain = fft3d.fft_plain
    if getattr(plain, "counted", False):
        return

    def counted(x, dims, fft_direction):
        if x.is_cuda and x.ndim == 4:
            _CARD_FFT_PLAIN[0] += 1
        return plain(x, dims, fft_direction)
    counted.counted = True
    fft3d.fft_plain = counted


def reset_launches():
    count_card_fft_plain()
    _CARD_FFT_PLAIN[0] = 0
    for fn in wrappers().values():
        fn.launches = 0


def read_launches(phase, fft_calls=0):
    """Launch counts of the kernels the main-path ``phase`` must run;
    fails if one was launched no time, or if torch.fft ran on a rank-3
    grid on the card other than the ``fft_calls`` times the path calls it
    by design (a stage the JAX package runs in XLA, not in Pallas)."""
    wrap = wrappers()
    launches = {name: wrap[name].launches for name in PHASE_KERNELS[phase]}
    log(f"{phase} main-path launches: {launches}; rank-3 torch.fft calls "
        f"on the card: {_CARD_FFT_PLAIN[0]}")
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise RuntimeError(f"{phase} main path did not launch {missing}")
    if _CARD_FFT_PLAIN[0] != fft_calls:
        raise RuntimeError(f"{phase} main path ran torch.fft on a rank-3 "
                           f"grid on the card {_CARD_FFT_PLAIN[0]} times, "
                           f"want {fft_calls}")
    return launches


def step_launches():
    """Every wrapper's count (for per-step logs)."""
    counts = {}
    for fn in wrappers().values():
        counts[fn.__name__] = fn.launches
    return counts


def hold(name, kernel, plain, results, launches=1, rtol=KERNEL_RTOL,
         counter=None):
    """Runs ``kernel`` once (the launch count of its wrapper, or of
    ``counter``, must rise by ``launches``) and holds it to ``plain``
    within ``rtol`` of the peak; records the max abs error."""
    import torch
    fn = counter or wrappers()[name]
    before = fn.launches
    got = kernel()
    torch.cuda.synchronize()
    if fn.launches != before + launches:
        raise RuntimeError(f"{name}: launch counter did not rise")
    ref = plain()
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    err = float((got - ref).abs().max())
    peak = float(ref.abs().max())
    log(f"kernel {name}: max|kernel - plain| {err:.3e} (peak {peak:.3e}, "
        f"bound {rtol * peak:.3e})")
    if not (np.isfinite(err) and err <= rtol * peak):
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"{err:.3e} > {rtol:g} * {peak:.3e}")
    res = results.setdefault(name, {"max_abs_err": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)


def time_pair(name, kernel, plain, results, work, plain_reps=5,
              library=None, label=None):
    """Times ``kernel`` and ``plain`` (``plain_reps`` runs: it is no
    yardstick of speed) and, where one PyTorch call computes the same
    function, that ``library`` call, and records them with the bound of
    ``work`` = (bytes, operations)."""
    res = results[name]
    res["ms"] = cuda_ms(kernel)
    res["plain_ms"] = cuda_ms(plain, reps=plain_reps, warmup=1)
    res["bound_ms"], res["bound_by"] = bound(*work)
    lib = ""
    if library is not None:
        res["library_ms"] = cuda_ms(library)
        lib = f", library {res['library_ms']:.4f} ms"
    log(f"time {label or name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms{lib}, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {work[0]:.4e} B, {work[1]:.4e} flop)")


def library_call(kind, geom, batch, source, out, axes=3):
    """The one PyTorch call that computes the halo kernel ``kind`` on
    ``source`` (the yardstick; the port never calls it): a gather,
    ``torch.take`` of the grid's float32 view, for "extend"; a zero fill
    and one ``index_add_`` of the flat tile array for "fold". Both use an
    int64 index of the tile array's shape [*tiles, 2B, *ext] (axes 2: y
    [nt0, nt1, 2B, E0, E1, n2]) into the flat float32 view of the grid
    [B, *fine, 2], built here, outside the timed call. Raises unless the
    call gives the kernel's output ``out``."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning
    fine = (batch,) + geom.fine_shape
    flat = torch.arange(2 * int(np.prod(fine)), device=source.device)
    index = binning.extend_tiles(flat.reshape(fine + (2,)).movedim(-1, 1)
                                 .reshape((2 * batch,) + geom.fine_shape),
                                 geom)
    if axes == 2:   # one untiled block on axis 2: its core, no halo
        index = index[:, :, 0].narrow(-1, geom.pad, geom.tile[2])
    index = index.contiguous()
    if kind == "extend":
        grid = torch.view_as_real(source)

        def call():
            return torch.take(grid, index)
        same = bool(torch.equal(call(), out))
    else:
        src, index = source.reshape(-1), index.reshape(-1)

        def call():
            return torch.zeros(flat.numel(), device=src.device).index_add_(
                0, index, src)
        want = call()
        err = float((torch.view_as_real(out).reshape(-1) - want).abs().max())
        same = err <= KERNEL_RTOL * float(want.abs().max())
    if not same:
        raise RuntimeError(f"the {kind} library call computes another "
                           f"function")
    return call


def halo_phase(label, geom, batch, tiles, fine, results, y=None,
               plain_reps=5):
    """extend_tiles3d and fold3d (and fold2 on the fused route's ``y``)
    at ``geom``: held to their plain versions, repeated bit for bit, and
    timed beside their library calls (``library_call``: torch.take, or a
    zero fill and index_add_, with an int64 index built outside the
    timed call) and bounds into ``results``."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import mode3d
    wrap = wrappers()
    # (bytes, operations): tile array and grid once each, one add per
    # tile element for the fold.
    nbytes = 4 * tiles.numel() + 8 * fine.numel()
    cases = [("extend_tiles3d", functools.partial(
                  wrap["extend_tiles3d"], fine, geom),
              functools.partial(mode3d.extend_plain, fine, geom),
              fine, (nbytes, 0), 3, geom),
             ("fold3d", functools.partial(wrap["fold3d"], tiles, geom,
                                          batch),
              functools.partial(mode3d.fold_plain, tiles, geom, batch),
              tiles, (nbytes, tiles.numel()), 3, geom)]
    if y is not None:
        g2 = mode3d._modes2_geometry(geom, y.shape[-1])
        cases.append(("fold2", functools.partial(wrap["fold2"], y, geom,
                                                 batch),
                      functools.partial(mode3d.fold_plain, y, geom, batch,
                                        axes=2),
                      y, (4 * y.numel() + 8 * batch * int(np.prod(
                          g2.fine_shape)), y.numel()), 2, g2))
    for name, kernel, plain, source, work, axes, g in cases:
        hold(name, kernel, plain, results)
        first = kernel()
        if not all(torch.equal(first, kernel()) for _ in range(2)):
            raise RuntimeError(f"{name} at {label} is not bit-repeatable")
        library = library_call("extend" if name == "extend_tiles3d"
                               else "fold", g, batch, source, first, axes)
        time_pair(name, kernel, plain, results, work, plain_reps, library,
                  f"{name} {label}")
        del first, library
        torch.cuda.empty_cache()


def fft_phase(label, x, dims, direction, plain_reps=5):
    """The FFT kernel's full-grid mode (fft3d_cuda, on no path of the
    port) over ``dims`` of the complex64 grid ``x``: held to its plain
    version (torch.fft, which is also the one library call of the same
    function, cuFFT) within 2e-6 of the peak, repeated bit for bit, and
    timed beside it with the bound: the grid read and written once, 5 N
    log2 N flops per transform of N cells."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import fft3d
    kernel = functools.partial(fft3d.fft3d_cuda, x, dims, direction)
    plain = functools.partial(fft3d.fft_plain, x, dims, direction)
    splits = sum(fft3d.split_of(x.shape[d]) is not None for d in dims)
    results = {}
    hold("fft3d", kernel, plain, results, launches=len(dims) + splits,
         rtol=FFT_RTOL, counter=fft3d.fft3d_cuda)
    if not torch.equal(kernel(), kernel()):
        raise RuntimeError(f"fft3d at {label} is not bit-repeatable")
    cells = int(np.prod([x.shape[d] for d in dims]))
    work = (16 * x.numel(), 5 * x.numel() * np.log2(cells))
    time_pair("fft3d", kernel, plain, results, work, plain_reps, plain,
              f"fft3d (full grid) {label} {tuple(x.shape)} dims "
              f"{tuple(dims)} {direction}")
    torch.cuda.empty_cache()


def stage_passes(plan, batch, kind):
    """(outer, n, inner, cells in, cells out) of each pruned pass of a
    mode stage: ``kind`` "to_fine" (modes_to_fine), "to_modes"
    (fine_to_modes) or "to_modes2" (the fused route's two axes)."""
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    if kind == "to_fine":
        return [(batch * n0 * n1, f2, 1, n2, f2), (batch * n0, f1, f2, n1, f1),
                (batch, f0, f1 * f2, n0, f0)]
    out = [(batch * f0, f1, n2, f1, n1), (batch, f0, n1 * n2, f0, n0)]
    if kind == "to_modes":
        out.insert(0, (batch * f0 * f1, f2, 1, f2, n2))
    return out


def stage_work(plan, batch, kind):
    """(bytes, operations) of a mode stage as a function: its input read
    once and its output written once (and the weights), 5 n log2 n flops
    a line of each pass; and the bytes its pruned passes move (each
    pass's input and output once)."""
    passes = stage_passes(plan, batch, kind)
    first, last = passes[0], passes[-1]
    nbytes = 8 * (first[0] * first[3] * first[2]
                  + last[0] * last[4] * last[2]) + 4 * sum(plan.grid_shape)
    ops = sum(5 * o * i * n * np.log2(n) for o, n, i, _, _ in passes)
    moved = sum(8 * o * i * (a + b) for o, _, i, a, b in passes)
    return (nbytes, ops), moved


def stage_phase(label, plan, batch, results, gen, kinds=None,
                plain_reps=REPS):
    """The pruned mode stages (modes_to_fine, fine_to_modes and the
    fused route's two-axis fine_to_modes) at ``plan`` and ``batch`` on
    seeded inputs: each held to its plain version (amplify_pad_plain
    then torch.fft; torch.fft then truncate_deconvolve_plain: the cuFFT
    route) within 2e-6 of the peak, repeated bit for bit, and timed
    beside it (``plain_reps`` runs) with its bound and the bound of the
    bytes its passes move, into ``results``."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import fft3d, mode3d
    direction = plan.spec.fft_direction
    grid, fine = tuple(plan.grid_shape), tuple(plan.fine_shape)
    modes = torch.randn((batch,) + grid + (2,), generator=gen,
                        device=gen.device)
    x = torch.complex(*(torch.randn((batch,) + fine, generator=gen,
                                    device=gen.device) for _ in range(2)))
    x2 = x[..., :grid[2]].contiguous()
    cases = {
        "modes_to_fine": (
            "to_fine", functools.partial(fft3d.modes_to_fine_cuda, modes,
                                         plan),
            lambda: fft3d.fft_plain(mode3d.amplify_pad_plain(modes, plan),
                                    (1, 2, 3), direction)),
        "fine_to_modes": (
            "to_modes", functools.partial(fft3d.fine_to_modes_cuda, x, plan),
            lambda: mode3d.truncate_deconvolve_plain(
                fft3d.fft_plain(x, (1, 2, 3), direction), plan)),
        "fine_to_modes2": (
            "to_modes2", functools.partial(fft3d.fine_to_modes_cuda, x2,
                                           plan, 2),
            lambda: mode3d.truncate_deconvolve_plain(
                fft3d.fft_plain(x2, (1, 2), direction), plan, axes=2))}
    for name, (kind, kernel, plain) in cases.items():
        if kinds is not None and name not in kinds:
            continue
        passes = stage_passes(plan, batch, kind)
        launches = sum(len(fft3d.axis_launches(o, n, i)) for o, n, i, _, _
                       in passes)
        hold(name, kernel, plain, results, launches=launches, rtol=FFT_RTOL)
        first = kernel()
        if not torch.equal(first, kernel()):
            raise RuntimeError(f"{name} at {label} is not bit-repeatable")
        del first
        work, moved = stage_work(plan, batch, kind)
        time_pair(name, kernel, plain, results, work, plain_reps,
                  label=f"{name} {label} batch {batch}")
        log(f"{name} {label} batch {batch}: {launches} launches; its "
            f"passes move {moved:.4e} B (bound "
            f"{moved / PEAK_BYTES_PER_S * 1e3:.4f} ms)")
        torch.cuda.empty_cache()


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


def exact2d_type2(f, x, sign, n=GRID):
    """Type-2 NUDFT in complex128 of modes f [B, n, n] (CMCL order) at
    points x [M, 2]: exp(sign i k.x) -> [B, M]."""
    import torch
    k = torch.arange(n, dtype=torch.float64, device=x.device) - n // 2
    ax = torch.exp(sign * 1j * torch.outer(x[:, 0], k))
    ay = torch.exp(sign * 1j * torch.outer(x[:, 1], k))
    return torch.sum(ax * (ay @ f.transpose(1, 2)), dim=-1)


def exact2d_type1(c, x, sign, n=GRID):
    """Type-1 NUDFT in complex128 of point values c [B, M] at x [M, 2]
    onto the n x n modes: exp(sign i k.x) -> [B, n, n]."""
    import torch
    k = torch.arange(n, dtype=torch.float64, device=x.device) - n // 2
    ax = torch.exp(sign * 1j * torch.outer(x[:, 0], k))
    ay = torch.exp(sign * 1j * torch.outer(x[:, 1], k))
    return (ax[None] * c[..., None]).transpose(1, 2) @ ay


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
    launches = read_launches("2d")

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

    x64 = torch.from_numpy(points.astype(np.float64)).to(dev)
    exact1 = exact2d_type1(torch.from_numpy(z.astype(np.complex128)).to(
        dev)[None], x64, -1.0)[0]
    exact2 = exact2d_type2(torch.from_numpy(modes.astype(np.complex128)).to(
        dev)[None], x64, -1.0)[0]
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
        err_total = rel(got, exact)
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
    from tensorflow_nufft_tpu_torch.kernels import (binning, fft3d, interp,
                                                    mode3d, spread)
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
    spec = fft3d.fft_plain(mode3d.fold_plain(tiles, geom, 1), (1, 2, 3),
                           "forward")
    log(f"3D bytes: tile array {tiles.numel() * 4:.4e}, fine grid "
        f"{spec.numel() * 8:.4e}, planned windows "
        f"{kw.weights.numel() * 4:.4e} + starts {kw.starts.numel() * 4:.4e}, "
        f"coords payload {coords.numel() * 4:.4e}")
    wrap = wrappers()
    m = NUM_POINTS3
    cases = {
        "spread3d_unplanned": (
            lambda: wrap["spread3d_unplanned"](values_pl, tb, geom, plan,
                                               coords),
            lambda: spread.spread_tiles_plain(values_pl, tb, geom, plan,
                                              coords=coords),
            tile_work("spread", False, geom, plan, 2, m, used)),
        "interp3d_unplanned": (
            lambda: wrap["interp3d_unplanned"](tiles, tb, geom, plan,
                                               coords),
            lambda: interp.interp_tiles_plain(tiles, tb, geom, plan,
                                              coords=coords),
            tile_work("interp", False, geom, plan, 2, m, used)),
    }
    results = {}
    for name, (kernel, plain, work) in cases.items():
        hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results, work)
    halo_phase("unbanded 3D headline", geom, 1, tiles, spec, results)
    # The per-slot-window kernels at the unbanded headline geometry, the
    # "mats" route at this geometry (rows 3 and 12 are timed at their
    # main-path size in planned_mats_phase_3d): held, and timed for the
    # comparison with the banded kernels.
    for name, kernel, plain, kind in (
            ("spread3d_planned_mats",
             functools.partial(wrap["spread3d_planned_mats"], values_pl, tb,
                               geom, plan, kw),
             functools.partial(spread.spread_tiles_plain, values_pl, tb,
                               geom, plan, kw=kw), "spread"),
            ("interp3d_planned_mats",
             functools.partial(wrap["interp3d_planned_mats"], tiles, tb,
                               geom, plan, kw),
             functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                               plan, kw=kw), "interp")):
        hold(name, kernel, plain, results)
        log(f"time {kind} per-slot windows at the unbanded 3D headline: "
            f"kernel {cuda_ms(kernel):.4f} ms, bound "
            f"{bound(*tile_work(kind, True, geom, plan, 2, m, used))[0]:.4f}"
            f" ms")
    # The pruned mode stages (the JSON keeps batch 1's), then the FFT
    # kernel's full-grid mode on the fine grid beside torch.fft, both
    # directions.
    stage_phase("3D headline", plan, 1, results, gen,
                ("modes_to_fine", "fine_to_modes"))
    stage_phase("3D headline", plan, 3, {}, gen,
                ("modes_to_fine", "fine_to_modes"))
    fft_phase("unbanded 3D headline", spec, (1, 2, 3), "backward")
    fft_phase("unbanded 3D headline", spec, (1, 2, 3), "forward")
    return results


MATS_POINTS3 = 200_000


def planned_mats_phase_3d(points3, dev):
    """TPU rows 3 and 12: the planned rank-3 kernels at a size where the
    JAX PlannedNufft keeps its dense kernel matrices (128^3 modes, the
    first 200,000 headline points: 2.218e8 B of matrices under the 256
    MiB budget, per the JAX package's mats_payload_bytes), so the TPU
    runs _spread_kernel_mats and _interp_kernel_mats. Runs a planned
    type-1 and its adjoint with launch counting, holds them to the
    unplanned transforms, and holds and times the two kernels against
    their plain versions."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    rng = np.random.default_rng(SEED + 9)
    m = MATS_POINTS3
    pts = torch.from_numpy(points3[:m]).to(dev)
    strengths = torch.from_numpy(rng.standard_normal((1, m, 2)).astype(
        np.float32)).to(dev)
    modes = torch.from_numpy(rng.standard_normal(
        (1,) + GRID3 + (2,)).astype(np.float32)).to(dev)
    reset_launches()
    op = tnt.PlannedNufft(pts, GRID3, transform_type="type_1", tol=TOL)
    t1 = op(strengths)
    t2 = op.adjoint()(modes)
    torch.cuda.synchronize()
    launches = read_launches("planned3d_mats")
    u1 = tnt.planar.nufft(strengths, pts, grid_shape=GRID3,
                          transform_type="type_1", tol=TOL)
    u2 = tnt.planar.nufft(modes, pts, fft_direction="backward", tol=TOL)
    for name, got, want in (("type-1", t1, u1), ("type-2", t2, u2)):
        err = rel(got, want)
        log(f"planned3d_mats {name}: planned vs unplanned {err:.3e} "
            f"(gate < {KERNEL_RTOL:g})")
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"planned3d_mats {name} disagrees with the "
                               f"unplanned transform")
    geom, binned, kw = op.geom, op.binned, op.weights
    tb = binned.tile_bounds
    used = int(tb[-1]) * geom.chunk
    log(f"planned3d_mats geometry: tiles {geom.tiles} ext {geom.ext} chunk "
        f"{geom.chunk} chunks {geom.num_chunks} (used {int(tb[-1])})")
    values_pl = binning.build_values_payload(
        strengths[0].t().contiguous(), binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (2,) + geom.ext).astype(np.float32)).to(dev)
    results = {}
    wrap = wrappers()
    for name, kernel, plain, kind in (
            ("spread3d_planned_mats",
             functools.partial(wrap["spread3d_planned_mats"], values_pl, tb,
                               geom, op.plan, kw),
             functools.partial(spread.spread_tiles_plain, values_pl, tb,
                               geom, op.plan, kw=kw), "spread"),
            ("interp3d_planned_mats",
             functools.partial(wrap["interp3d_planned_mats"], tiles, tb,
                               geom, op.plan, kw),
             functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                               op.plan, kw=kw), "interp")):
        hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results,
                  tile_work(kind, True, geom, op.plan, 2, m, used))
    return launches, results


LARGE3 = (256, 256, 256)
LARGE2 = (150, 150)
# The geometries the port's choose_geometry gives there: 2000 tiles of
# ext (32, 32, 80) at width 10 (the plan's sigma drops to 1.25 above
# 144^3), and one tile of ext (308, 308).
LARGE_GEOMETRY = {3: dict(fine_shape=(320, 320, 320), ext=(32, 32, 80),
                          tiles=(20, 20, 5)),
                  2: dict(fine_shape=(300, 300), ext=(308, 308),
                          tiles=(1, 1))}


def large_kernels(rank, pts, plan, dev, results):
    """The unplanned spread and interp at the large geometry of ``rank``
    against their plain versions (B2 = 2), timed."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    geom, binned = bin_for_plan(pts, plan)
    got = {k: getattr(geom, k) for k in LARGE_GEOMETRY[rank]}
    used = int(binned.tile_bounds[-1]) * geom.chunk
    log(f"large {rank}D plan: width {plan.width} sigma {plan.sigma}; "
        f"geometry {got} chunk {geom.chunk} chunks {geom.num_chunks} (used "
        f"{int(binned.tile_bounds[-1])}); spread launch "
        f"{spread.launch_shape(geom, 2, plan.width)} (group, slab, lines, "
        f"threads, smem); interp launch {interp.launch_shape(geom, 2)} "
        f"(group, slab, slots, threads, smem)")
    if got != LARGE_GEOMETRY[rank]:
        raise RuntimeError(f"large {rank}D geometry {got}")
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    m = pts.shape[0]
    values_pl = binning.build_values_payload(
        torch.randn((2, m), generator=gen, device=dev), binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    wrap = wrappers()
    tag = f"{rank}d_unplanned_large"
    for kind, kernel, plain in (
            ("spread", functools.partial(wrap[f"spread{tag}"], values_pl, tb,
                                         geom, plan, coords),
             functools.partial(spread.spread_tiles_plain, values_pl, tb, geom,
                               plan, coords=coords)),
            ("interp", functools.partial(wrap[f"interp{tag}"], tiles, tb,
                                         geom, plan, coords),
             functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                               plan, coords=coords))):
        hold(f"{kind}{tag}", kernel, plain, results)
        time_pair(f"{kind}{tag}", kernel, plain, results,
                  tile_work(kind, False, geom, plan, 2, m, used),
                  plain_reps=2)
    if rank == 3:
        # The halo kernels at this geometry (logged; the JSON keeps the
        # unbanded headline's).
        fine = torch.complex(*(torch.randn((1,) + geom.fine_shape,
                                           generator=gen, device=dev)
                               for _ in range(2)))
        halo_phase("large 3D tiles", geom, 1, tiles, fine, {}, plain_reps=2)
        del fine
        stage_phase("large 3D tiles", plan, 1, {}, gen,
                    ("modes_to_fine", "fine_to_modes"))
        fine = torch.complex(*(torch.randn((1,) + geom.fine_shape,
                                           generator=gen, device=dev)
                               for _ in range(2)))
        fft_phase("large 3D tiles", fine, (1, 2, 3), "forward",
                  plain_reps=2)


def floor_gates(label, got, f32, ref, exact, idx=None,
                ref_name="f64 plain pipeline"):
    """The accuracy gates of a transform whose float32 floor may lie above
    tol. err_total (against the exact NUDFT ``exact``, at the flat
    indices ``idx`` of the output, or everywhere) and err_impl (against
    the float64 reference ``ref``: the float64 plain pipeline, or
    ``ref_name``), both relative to the peak of
    ``ref``: below 10 * tol and tol (bench.py's gates) where the float32
    plain pipeline ``f32`` of the same plan reaches them, else below 4x
    that pipeline's own errors (the census rule for a float32 floor above
    tol, applied to both). Returns whether both hold."""
    import torch
    scale = float(ref.abs().max())
    exact = exact.reshape(-1)

    def errors(x):
        x = x.to(torch.complex128)
        flat = x.reshape(-1) if idx is None else x.reshape(-1)[idx]
        return (float((flat - exact).abs().max()) / scale,
                float((x - ref).abs().max()) / scale)
    err_total, err_impl = errors(got)
    total_f32, floor_f32 = errors(f32)
    gate_total = max(10 * TOL, 4 * total_f32)
    gate_impl = max(TOL, 4 * floor_f32)
    log(f"{label}: err_total (vs exact NUDFT) {err_total:.3e} (gate < "
        f"{gate_total:.3e}; f32 plain pipeline {total_f32:.3e}; below "
        f"10 * tol: {err_total < 10 * TOL}); err_impl (vs {ref_name}) "
        f"{err_impl:.3e} (gate < {gate_impl:.3e}; floor_f32 "
        f"{floor_f32:.3e}; below tol: {err_impl < TOL})")
    return err_total < gate_total and err_impl < gate_impl


def large_tiles_phase(points3, points, dev):
    """Extended tiles larger than one thread block's shared memory,
    through the unplanned planar.nufft a user calls: type-1 and type-2 at
    3D 256^3 modes on the 3D headline's 800,000 points (gated as the 3D
    census: err_total against complex128 NUDFTs on 4096-element subsets,
    err_impl against the float64 plain pipeline with the floor_f32 rule),
    then at 2D 150^2 on the 2D headline's 65,536 points (bench.py's
    gates: the exact NUDFT, and the float64 plain pipeline on the CPU
    below tol); launch counts of each; then the spread and interp
    kernels held to their plain versions at both geometries and
    timed."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    rng = np.random.default_rng(SEED + 11)
    phases, results = {}, {}
    # 3D.
    m3 = points3.shape[0]
    z = (rng.standard_normal(m3) + 1j * rng.standard_normal(m3)).astype(
        np.complex64)
    modes = (rng.standard_normal(LARGE3)
             + 1j * rng.standard_normal(LARGE3)).astype(np.complex64)
    pts = torch.from_numpy(points3).to(dev)
    srcs = {"t1": to_planar(z).to(dev), "t2": to_planar(modes).to(dev)}
    reset_launches()
    outs = {"t1": tnt.planar.nufft(srcs["t1"], pts, grid_shape=LARGE3,
                                   transform_type="type_1", tol=TOL),
            "t2": tnt.planar.nufft(srcs["t2"], pts, transform_type="type_2",
                                   tol=TOL)}
    torch.cuda.synchronize()
    phases["large3d"] = read_launches("large3d")
    sub = np.random.default_rng(SEED + 13)
    idx = {"t1": torch.from_numpy(np.sort(sub.choice(
               int(np.prod(LARGE3)), SUBSET, replace=False))).to(dev),
           "t2": torch.from_numpy(np.sort(sub.choice(
               m3, SUBSET, replace=False))).to(dev)}
    exact = {"t1": exact_type1_subset(points3, z, idx["t1"], dev,
                                      grid=LARGE3),
             "t2": exact_type2_subset(points3, modes, idx["t2"], -1.0, dev,
                                      grid=LARGE3)}
    del modes
    failed = []
    for key, ttype in (("t1", "type_1"), ("t2", "type_2")):
        spec = dict(transform_type=ttype, fft_direction="forward", rank=3,
                    grid_shape=LARGE3, tol=TOL, points_range=1)
        ref = from_planar(plain_pipeline(
            srcs[key][None].double(), pts.double(),
            make_plan(PlanSpec(dtype_name="complex128", **spec)))[0])
        f32 = from_planar(plain_pipeline(
            srcs[key][None], pts,
            make_plan(PlanSpec(dtype_name="complex64", **spec)))[0])
        out = outs[key]
        expect = LARGE3 + (2,) if key == "t1" else (m3, 2)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"large 3D {key}: shape {tuple(out.shape)} "
                               f"or non-finite values")
        if not floor_gates(f"large 3D {key} ({LARGE3[0]}^3 modes, {m3} "
                           f"points, {SUBSET} subset)", from_planar(out),
                           f32, ref, exact[key], idx[key]):
            failed.append(f"3d {key}")
        del ref, f32
    for key, fn in (("t1", lambda: tnt.planar.nufft(
            srcs["t1"], pts, grid_shape=LARGE3, transform_type="type_1",
            tol=TOL)), ("t2", lambda: tnt.planar.nufft(
                srcs["t2"], pts, transform_type="type_2", tol=TOL))):
        log(f"time large 3D {key} unplanned: {cuda_ms(fn, reps=5):.4f} ms")
    del outs, srcs
    torch.cuda.empty_cache()
    large_kernels(3, pts, make_plan(PlanSpec("type_1", "forward", 3, LARGE3,
                                             "complex64", TOL, 1)), dev,
                  results)
    del pts
    torch.cuda.empty_cache()
    # 2D.
    n = LARGE2[0]
    m2 = points.shape[0]
    z2 = (rng.standard_normal(m2) + 1j * rng.standard_normal(m2)).astype(
        np.complex64)
    modes2 = (rng.standard_normal(LARGE2)
              + 1j * rng.standard_normal(LARGE2)).astype(np.complex64)
    pts2 = torch.from_numpy(points).to(dev)
    reset_launches()
    outs = {"t1": tnt.planar.nufft(to_planar(z2).to(dev), pts2,
                                   grid_shape=LARGE2, transform_type="type_1",
                                   tol=TOL),
            "t2": tnt.planar.nufft(to_planar(modes2).to(dev), pts2,
                                   transform_type="type_2", tol=TOL)}
    torch.cuda.synchronize()
    phases["large2d"] = read_launches("large2d")
    x64 = torch.from_numpy(points.astype(np.float64))
    exact = {"t1": exact2d_type1(torch.from_numpy(z2.astype(np.complex128))
                                 .to(dev)[None], x64.to(dev), -1.0, n)[0],
             "t2": exact2d_type2(torch.from_numpy(modes2.astype(
                 np.complex128)).to(dev)[None], x64.to(dev), -1.0, n)[0]}
    exact = {key: v.cpu() for key, v in exact.items()}
    # The port's plain pipelines on the CPU, float64 and float32.
    plain = {}
    for dtype, cdtype in ((np.float64, np.complex128),
                          (np.float32, np.complex64)):
        x = torch.from_numpy(points.astype(dtype))
        plain[dtype] = {
            "t1": from_planar(tnt.planar.nufft(
                to_planar(z2.astype(cdtype)), x, grid_shape=LARGE2,
                transform_type="type_1", tol=TOL)),
            "t2": from_planar(tnt.planar.nufft(
                to_planar(modes2.astype(cdtype)), x,
                transform_type="type_2", tol=TOL))}
    for key, out in outs.items():
        expect = LARGE2 + (2,) if key == "t1" else (m2, 2)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"large 2D {key}: shape {tuple(out.shape)} "
                               f"or non-finite values")
        if not floor_gates(f"large 2D {key} ({n}^2 modes, {m2} points)",
                           from_planar(out).cpu(), plain[np.float32][key],
                           plain[np.float64][key], exact[key]):
            failed.append(f"2d {key}")
    if failed:
        raise RuntimeError(f"large-tile accuracy gates failed: {failed}")
    large_kernels(2, pts2, make_plan(PlanSpec("type_1", "forward", 2, LARGE2,
                                              "complex64", TOL, 1)), dev,
                  results)
    return phases, results


# Modes whose fine grid has an axis longer than one block's shared
# memory (40 bytes a cell: 5,811 cells), on axis 2 and on axis 0.
LONG3 = ((8, 8, 4096), (4096, 8, 8))
LONG_POINTS3 = 65_536


def long_axis_phase(dev):
    """3D transforms whose fine grid ((16, 16, 8192), (8192, 16, 16)) has
    a line longer than shared memory, which the FFT kernel takes in two
    launches (the four-step split): at each of LONG3 with 65,536 seeded
    uniform points, tol 1e-6, the unplanned planar.nufft type-1 and
    type-2 and PlannedNufft type-1 and its adjoint, with launch counting
    (no torch.fft on the card); gated as phase 7 (err_total against
    complex128 NUDFTs on 4096-element subsets, err_impl against the
    float64 plain pipeline with the floor_f32 rule)."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    rng = np.random.default_rng(SEED + 14)
    m = LONG_POINTS3
    points = rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32)
    z = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64)
    pts, strengths = (torch.from_numpy(points).to(dev),
                      to_planar(z).to(dev))
    total = {}
    for grid in LONG3:
        modes = (rng.standard_normal(grid)
                 + 1j * rng.standard_normal(grid)).astype(np.complex64)
        modes_p = to_planar(modes).to(dev)
        reset_launches()
        op = tnt.PlannedNufft(pts, grid, transform_type="type_1", tol=TOL)
        outs = {"t1_planned": op(strengths[None])[0],
                "t2_planned": op.adjoint()(modes_p[None])[0],
                "t1_unplanned": tnt.planar.nufft(
                    strengths, pts, grid_shape=grid, transform_type="type_1",
                    tol=TOL),
                "t2_unplanned": tnt.planar.nufft(
                    modes_p, pts, transform_type="type_2",
                    fft_direction="backward", tol=TOL)}
        torch.cuda.synchronize()
        for name, n in read_launches("3d_long").items():
            total[name] = total.get(name, 0) + n
        log(f"3d_long {grid}: fine {op.plan.fine_shape}, level {op.level}, "
            f"tiles {op.geom.tiles} of ext {op.geom.ext}")
        sub = np.random.default_rng(SEED + 15)
        idx = {"t1": torch.from_numpy(np.sort(sub.choice(
                   int(np.prod(grid)), SUBSET, replace=False))).to(dev),
               "t2": torch.from_numpy(np.sort(sub.choice(
                   m, SUBSET, replace=False))).to(dev)}
        exact = {"t1": exact_type1_subset(points, z, idx["t1"], dev,
                                          grid=grid),
                 "t2": exact_type2_subset(points, modes, idx["t2"], 1.0,
                                          dev, grid=grid)}
        failed = []
        for key, ttype, direction, src in (
                ("t1", "type_1", "forward", strengths),
                ("t2", "type_2", "backward", modes_p)):
            spec = dict(transform_type=ttype, fft_direction=direction,
                        rank=3, grid_shape=grid, tol=TOL, points_range=1)
            ref = from_planar(plain_pipeline(
                src[None].double(), pts.double(),
                make_plan(PlanSpec(dtype_name="complex128", **spec)))[0])
            f32 = from_planar(plain_pipeline(
                src[None], pts,
                make_plan(PlanSpec(dtype_name="complex64", **spec)))[0])
            scale = float(ref.abs().max())
            floor = float((f32.to(torch.complex128) - ref).abs().max()
                          / scale)
            for name in (f"{key}_planned", f"{key}_unplanned"):
                got = from_planar(outs[name]).to(torch.complex128)
                err_total = float((got.reshape(-1)[idx[key]]
                                   - exact[key]).abs().max() / scale)
                err_impl = float((got - ref).abs().max() / scale)
                gate_impl = max(TOL, 4 * floor)
                log(f"3d_long {grid} {name}: err_total {err_total:.3e} "
                    f"(gate < {10 * TOL:g}); err_impl {err_impl:.3e} (gate "
                    f"< {gate_impl:.3e}; floor_f32 {floor:.3e})")
                if not (err_total < 10 * TOL and err_impl < gate_impl):
                    failed.append(name)
        if failed:
            raise RuntimeError(f"3d_long {grid} accuracy gates failed: "
                               f"{failed}")
        del op, outs, modes_p, exact
        torch.cuda.empty_cache()
    return total


def plain_pipeline(source, points, plan):
    """The port's plain versions composed directly, with no dispatch: the
    reference pipelines of the 3D and training gates. source: [B, M, 2]
    (type-1) or [B, *grid, 2] (type-2). Runs on the tensors' device (the
    card here), in their dtype."""
    from tensorflow_nufft_tpu_torch.kernels import (binning, fft3d, interp,
                                                    mode3d, spread)
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    geom, binned = bin_for_plan(points, plan)
    dims = tuple(range(1, plan.rank + 1))
    kw = binning.build_weight_payload(binned, geom, plan)
    tb = binned.tile_bounds
    direction = plan.spec.fft_direction
    batch = source.shape[0]
    if plan.spec.transform_type == "type_1":
        values = binning.build_values_payload(
            source.movedim(-1, 1).reshape(2 * batch, -1), binned)
        tiles = spread.spread_tiles_plain(values, tb, geom, plan, kw=kw)
        spec = fft3d.fft_plain(mode3d.fold_plain(tiles, geom, batch), dims,
                               direction)
        return mode3d.truncate_deconvolve_plain(spec, plan)
    fine = fft3d.fft_plain(mode3d.amplify_pad_plain(source, plan), dims,
                           direction)
    tiles = mode3d.extend_plain(fine, geom)
    chunk_vals = interp.interp_tiles_plain(tiles, tb, geom, plan, kw=kw)
    flat = chunk_vals.transpose(0, 1).reshape(2 * batch, geom.num_slots)
    return binning.scatter_chunked(flat, binned).reshape(
        batch, 2, -1).movedim(1, -1)


def mode_freqs(flat, dev, grid=GRID3):
    """[S, 3] float64 frequencies k = i - n//2 of flat mode indices."""
    import torch
    half = torch.tensor([n // 2 for n in grid], device=dev)
    return (torch.stack(torch.unravel_index(flat, grid), dim=-1)
            - half).double()


def exact_type1_subset(points, z, idx, dev, sign=-1.0, grid=GRID3):
    """Type-1 NUDFT (exp(sign i k.x), forward by default) in complex128 at
    the flat mode indices ``idx`` of ``grid``, summed over all points in
    chunks."""
    import torch
    k = mode_freqs(idx, dev, grid)                          # [S, 3]
    x = torch.as_tensor(points, device=dev).double()
    c = torch.as_tensor(z, device=dev).to(torch.complex128)
    out = torch.zeros(len(idx), dtype=torch.complex128, device=dev)
    for lo in range(0, len(x), 8192):
        phase = sign * (x[lo:lo + 8192] @ k.T)              # [chunk, S]
        out += c[lo:lo + 8192] @ torch.polar(torch.ones_like(phase), phase)
    return out


def exact_type2_subset(points, modes, idx, direction_sign, dev,
                       grid=GRID3):
    """Type-2 NUDFT in complex128 at the points ``idx``, summed over all
    modes (of ``grid``) in chunks."""
    import torch
    x = torch.as_tensor(points, device=dev).double()[idx]  # [S, 3]
    f = torch.as_tensor(modes, device=dev).to(torch.complex128).reshape(-1)
    out = torch.zeros(len(idx), dtype=torch.complex128, device=dev)
    step = 16384
    for lo in range(0, f.numel(), step):
        k = mode_freqs(torch.arange(lo, min(lo + step, f.numel()),
                                    device=dev), dev, grid)
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
    g = op1.geom
    log(f"3D plan level {op1.level}: tiles {g.tiles} x {g.tile} ext {g.ext} "
        f"chunk {g.chunk} chunks {g.num_chunks} (used "
        f"{int(op1.binned.tile_bounds[-1])}); num_slots {op1.num_slots}; "
        f"band {op1.band_info.band if op1.band_info else None} with "
        f"{op1.band_info.zorigins.numel() if op1.band_info else 0} "
        f"sub-chunk origins (16 expected for these points)")
    if op1.level != "binned" or op1.band_info is None:
        raise RuntimeError("the 3D headline plan did not take the banded "
                           "binned level")
    launches = read_launches("3d")
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
            src[None].double(), pts.double(),
            make_plan(PlanSpec(dtype_name="complex128", **spec)))[0])
        f32 = from_planar(plain_pipeline(
            src[None], pts,
            make_plan(PlanSpec(dtype_name="complex64", **spec)))[0])
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
    """The 3D transforms at the binned level, then the planned ones and
    the plan build on the "mats" route (per-slot windows on the unbanded
    geometry: the budget raised for them) on the same card."""
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.kernels import binning
    def build_mats():
        budget = binning.MATS_BYTES_BUDGET
        binning.MATS_BYTES_BUDGET = 2 ** 40
        try:
            return tnt.PlannedNufft(pts, GRID3, transform_type="type_1",
                                    tol=TOL)
        finally:
            binning.MATS_BYTES_BUDGET = budget
    mats = build_mats()
    if mats.level != "mats":
        raise RuntimeError("the raised budget did not give the mats level")
    cases = transform_cases(op1, adj, pts, strengths, modes_p, GRID3,
                            dict(fft_direction="backward"))
    mats_cases = {"t1_planned": lambda: mats(strengths[None]),
                  "t2_planned": lambda: mats.adjoint()(modes_p[None])}
    # The planned transforms of both routes in turns (binned, mats, mats,
    # binned), so that they share the card's state.
    for name, mats_fn in mats_cases.items():
        turns = {op1.level: [], "mats": []}
        for level in (op1.level, "mats", "mats", op1.level):
            fn = cases[name] if level == op1.level else mats_fn
            turns[level].append(cuda_ms(fn))
        log(f"time 3d_{name} in turns: {op1.level} {turns[op1.level]} ms, "
            f"mats {turns['mats']} ms (means "
            f"{np.mean(turns[op1.level]):.4f} / "
            f"{np.mean(turns['mats']):.4f} ms)")
    cases.update({"t1_planned_mats": mats_cases["t1_planned"],
                  "t2_planned_mats": mats_cases["t2_planned"],
                  "plan_build_mats": build_mats})
    for name, fn in cases.items():
        ms = cuda_ms(fn)
        if name.startswith("plan_build"):
            log(f"time 3d {name} (PlannedNufft type-1, level "
                f"{'mats' if name.endswith('mats') else op1.level}): "
                f"{ms:.4f} ms")
        else:
            log(f"time 3d_{name}: {ms:.4f} ms per transform, "
                f"{NUM_POINTS3 / (ms * 1e-3):.4e} points/s")


def kernel_phase_binned(op, dev):
    """The binned level's kernels at the 3D headline (``op``: the
    binned-level type-1 plan, z-ordered on the coarse axis-0 geometry),
    each against its plain version on the card: the banded spread at B2
    = 2 and 4 and with slot-order values, the banded interp (its chunk-
    and point-order outputs), the fused spread with the axis-2 epilogue,
    the two-axis fold and truncation, and the fused against the staged
    planned type-1."""
    import torch
    from tensorflow_nufft_tpu_torch.fft import planar_fft
    from tensorflow_nufft_tpu_torch.kernels import (binning, dispatch, fft3d,
                                                    interp, mode3d, spread)
    geom, binned, plan = op.geom, op.binned, op.plan
    coords, band, tb = op.coords, op.band_info, op.binned.tile_bounds
    m, used = NUM_POINTS3, int(tb[-1]) * geom.chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    values = {b2: binning.build_values_payload(torch.randn(
        (b2, m), generator=gen, device=dev), binned) for b2 in (2, 4)}
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    # Slot-order values, zero in padded slots, as apply_from_slots and
    # normal pass them.
    slots = op.to_slots(torch.randn((1, m, 2), generator=gen, device=dev))
    slots = slots[0].t().contiguous()
    twiddles = planar_fft.dfta_twiddles(plan, geom, dev)
    y = spread.dfta_plain(spread.spread_tiles_plain(
        values[2], tb, geom, plan, coords=coords, band=band), twiddles)
    log(f"3D binned bytes: banded tile array {tiles.numel() * 4:.4e}, y "
        f"{y.numel() * 4:.4e}, coords payload {coords.numel() * 4:.4e}, "
        f"twiddles {twiddles.numel() * 4:.4e}")
    wrap = wrappers()
    nt2, e2 = geom.tiles[2], geom.ext[2]
    spread_work = tile_work("spread", False, geom, plan, 2, m, used)
    # The epilogue: per y pair and t2 tile, three E2-long dot products and
    # the xr + xi sum, 7 operations per E2 element.
    epi_ops = (y.numel() // 2) * nt2 * 7 * e2
    # The fused kernel writes y in place of the tile array.
    tile_bytes = 4 * geom.num_tiles * 2 * int(np.prod(geom.ext))
    cases = {
        "spread3d_banded": (
            functools.partial(wrap["spread3d_banded"], values[2], tb, geom,
                              plan, coords, band),
            functools.partial(spread.spread_tiles_plain, values[2], tb, geom,
                              plan, coords=coords, band=band), spread_work),
        "spread3d_banded_split": (
            functools.partial(wrap["spread3d_banded_split"], slots, tb, geom,
                              plan, coords, band),
            functools.partial(spread.spread_tiles_plain, slots, tb, geom,
                              plan, coords=coords, band=band), spread_work),
        "interp3d_banded": (
            functools.partial(wrap["interp3d_banded"], tiles, tb, geom, plan,
                              coords, band),
            functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                              plan, coords=coords, band=band),
            tile_work("interp", False, geom, plan, 2, m, used)),
        "spread3d_dfta": (
            functools.partial(wrap["spread3d_dfta"], values[2], tb, geom,
                              plan, coords, band, twiddles),
            lambda: spread.dfta_plain(spread.spread_tiles_plain(
                values[2], tb, geom, plan, coords=coords, band=band),
                twiddles),
            (spread_work[0] - tile_bytes + 4 * y.numel()
             + 4 * twiddles.numel(), spread_work[1] + epi_ops)),
    }
    results = {}
    for name, (kernel, plain, work) in cases.items():
        hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results, work)
    # The halo kernels at the banded geometry, and fold2 (the fused
    # route's two-axis fold, whose times the JSON keeps); the JSON keeps
    # extend_tiles3d's and fold3d's at the unbanded headline (phase 6).
    fine = torch.complex(*(torch.randn((1,) + geom.fine_shape, generator=gen,
                                       device=dev) for _ in range(2)))
    halo = {}
    halo_phase("banded 3D headline", geom, 1, tiles, fine, halo, y)
    results["fold2"] = halo["fold2"]
    # The fused route's pruned passes of axes 1 and 0 (the JSON keeps
    # them), and the full-grid FFT of the folded y's two axes.
    stage_phase("fused route", plan, 1, results, gen, ("fine_to_modes2",))
    fft_phase("fused route", wrap["fold2"](y, geom, 1), (1, 2), "forward")
    del fine, halo
    extra = {}
    hold("spread3d_banded_split", functools.partial(
        wrap["spread3d_banded_split"], values[4], tb, geom, plan, coords,
        band), functools.partial(spread.spread_tiles_plain, values[4], tb,
                                 geom, plan, coords=coords, band=band), extra)
    ms4 = cuda_ms(functools.partial(wrap["spread3d_banded"], values[4], tb,
                                    geom, plan, coords, band))
    log(f"time spread3d_banded B2 4: kernel {ms4:.4f} ms, bound "
        f"{bound(*tile_work('spread', False, geom, plan, 4, m, used))[0]:.4f}"
        f" ms")
    results["spread3d_banded_split"]["max_abs_err"] = max(
        results["spread3d_banded_split"]["max_abs_err"],
        extra["spread3d_banded_split"]["max_abs_err"])
    # One owner and a fixed order per output: bit-repeatable run to run.
    for name in ("spread3d_banded", "interp3d_banded"):
        kernel = cases[name][0]
        first = kernel()
        same = all(torch.equal(first, kernel()) for _ in range(2))
        log(f"kernel {name}: bit-repeatable over 3 runs: {same}")
        if not same:
            raise RuntimeError(f"{name} is not bit-repeatable")
    # The banded interp's point-order output (its plain version's through
    # the same gather).
    got = dispatch.interp_tiled(tiles, binned, geom, plan, coords=coords,
                                band=band)
    want = binning.scatter_chunked(cases["interp3d_banded"][1]().transpose(
        0, 1).reshape(2, -1), binned)
    err = rel(got, want)
    log(f"interp3d_banded point order: vs plain {err:.3e} (gate < "
        f"{KERNEL_RTOL:g})")
    if not err <= KERNEL_RTOL:
        raise RuntimeError("interp3d_banded point order disagrees")
    return results


def routes_phase_3d(op, strengths):
    """The planned type-1 on the fused and the staged route (the gate
    forced each way), held to each other and timed in turns (fused,
    staged, staged, fused): the times the port's gate is set from."""
    from tensorflow_nufft_tpu_torch.fft import planar_fft
    gate = planar_fft.FUSED_DFTA
    src = strengths[None]
    times, outs = {True: [], False: []}, {}
    try:
        for fused in (True, False, False, True):
            planar_fft.FUSED_DFTA = fused
            outs[fused] = op(src)
            times[fused].append(cuda_ms(lambda: op(src), reps=12))
    finally:
        planar_fft.FUSED_DFTA = gate
    err = rel(outs[True], outs[False])
    log(f"3D planned type-1 routes: fused {times[True]} ms, staged "
        f"{times[False]} ms (means {np.mean(times[True]):.4f} / "
        f"{np.mean(times[False]):.4f} ms); fused vs staged {err:.3e} (gate "
        f"< {KERNEL_RTOL:g}); the gate takes "
        f"{'fused' if planar_fft.fused_route(op.geom, op.band_info) else 'staged'}")
    if not err <= KERNEL_RTOL:
        raise RuntimeError("the fused and staged type-1 routes disagree")


def fused_phase_3d(op, strengths, modes_p):
    """The binned level's fused route as a caller who turns the gate on
    (``planar_fft.FUSED_DFTA``) runs it, with launch counting: the planned
    type-1 and ``normal`` on its adjoint, held to the default route."""
    import torch
    from tensorflow_nufft_tpu_torch.fft import planar_fft
    adj, gate = op.adjoint(), planar_fft.FUSED_DFTA
    want = (op(strengths[None]), adj.normal(modes_p[None]))
    planar_fft.FUSED_DFTA = True
    try:
        reset_launches()
        got = (op(strengths[None]), adj.normal(modes_p[None]))
        torch.cuda.synchronize()
        launches = read_launches("3d_fused")
    finally:
        planar_fft.FUSED_DFTA = gate
    for name, a, b in zip(("type-1", "normal"), got, want):
        err = rel(a, b)
        log(f"3D fused route {name}: vs the staged route {err:.3e} (gate < "
            f"{KERNEL_RTOL:g})")
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"3D fused route {name} disagrees")
    return launches


def slots_phase(label, t2, x, c, density, phase):
    """The planned surface on the type-2 plan ``t2`` (its adjoint the
    type-1): ``normal`` with and without ``slot_weights`` of a density
    vector against adjoint()(t2(x)) with the same weights, and the
    slot-order applies against the slot conversions of the point-order
    ones, to 1e-5 of the peak; launch counts of the main path ``phase``
    and times of ``normal`` against the composed pair."""
    import torch
    t1 = t2.adjoint()
    slot_w = t2.slot_weights(density)
    slots_c = t1.to_slots(c)
    reset_launches()
    outs = {"normal": t2.normal(x), "normal_w": t2.normal(x, slot_w),
            "apply_to_slots": t2.apply_to_slots(x),
            "apply_from_slots": t1.apply_from_slots(slots_c)}
    torch.cuda.synchronize()
    launches = read_launches(phase)
    vals = t2(x)
    refs = {"normal": t1(vals), "normal_w": t1(vals * density[None, :, None]),
            "apply_to_slots": t2.to_slots(vals), "apply_from_slots": t1(c)}
    for name, out in outs.items():
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label} {name} has non-finite values")
        err = rel(out, refs[name])
        log(f"{label} {name}: vs the point-order composition {err:.3e} "
            f"(gate < {KERNEL_RTOL:g})")
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"{label} {name} disagrees with its "
                               f"composition")
    dead = outs["apply_to_slots"][:, t2.slot_mask == 0]
    if bool(dead.any()):
        raise RuntimeError(f"{label} apply_to_slots: nonzero dead slots")
    for name, fn in (("normal_w", lambda: t2.normal(x, slot_w)),
                     ("composed", lambda: t1(t2(x) * density[None, :, None])),
                     ("normal_w", lambda: t2.normal(x, slot_w)),
                     ("apply_to_slots", lambda: t2.apply_to_slots(x)),
                     ("apply_from_slots", lambda: t1.apply_from_slots(
                         slots_c))):
        log(f"time {label} {name}: {cuda_ms(fn):.4f} ms")
    return launches


# ---------------------------------------------------------------------------
# Training: autograd through the port on the card.
# ---------------------------------------------------------------------------

TRAIN_BATCH = 8      # coils of bench_suite's 2d_t2_512_radial_b8 cases
TYPE1_BATCH = 3      # B2 = 6: the JAX plan's resident split spread
# rad: std of the trajectory error the data carry. Large enough that the
# residual is as large as A x, so that the transform's error relative to
# A x is not magnified in the gradients' relative error.
SHIFT = 5e-2
LR_X, LR_K = 1e-2, 2e-4    # Adam step sizes of the image and trajectory
STEP_REPS = 5
FD_POINTS = 3
FD_STEP = 1e-5       # rad
FD_RTOL = 1e-4


def kernel_phase_train(rng, points, points3, dev):
    """The training kernels against their plain versions: the derivative
    interp on each axis and the unplanned spread at 6, 16 and 32 channels
    at the 2D headline geometry; at 3D, the derivative interp on axis 0
    and the spread at 6 channels."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    wrap = wrappers()
    results = {}
    for rank, pts, grid in ((2, points, (GRID, GRID)), (3, points3, GRID3)):
        # The transform plan; the spread-only ops' plan of its fine grid
        # has the same kernel, fine grid and geometry.
        plan = make_plan(PlanSpec("type_1", "forward", rank, grid,
                                  "complex64", TOL, 1))
        geom, binned = bin_for_plan(torch.from_numpy(pts).to(dev), plan)
        coords = binning.build_coords_payload(binned)
        tb = binned.tile_bounds
        m = pts.shape[0]
        used = int(tb[-1]) * geom.chunk
        tiles = torch.from_numpy(rng.standard_normal(
            geom.tiles + (2,) + geom.ext).astype(np.float32)).to(dev)
        name = "interp_deriv" if rank == 2 else "interp3d_deriv"
        for axis in range(rank if rank == 2 else 1):
            kernel = functools.partial(wrap[name], tiles, tb, geom, plan,
                                       coords, axis)
            plain = functools.partial(interp.interp_tiles_plain, tiles, tb,
                                      geom, plan, coords=coords,
                                      deriv_axis=axis)
            hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results,
                  tile_work("interp", False, geom, plan, 2, m, used))
        for b2 in ((6, 16, 32) if rank == 2 else (6,)):
            values_pl = binning.build_values_payload(torch.from_numpy(
                rng.standard_normal((b2, m)).astype(np.float32)).to(dev),
                binned)
            kernel = functools.partial(spread.spread_unplanned_cuda,
                                       values_pl, tb, geom, plan, coords)
            plain = functools.partial(spread.spread_tiles_plain, values_pl,
                                      tb, geom, plan, coords=coords)
            work = tile_work("spread", False, geom, plan, b2, m, used)
            group = spread.launch_shape(geom, b2, plan.width)[0]
            log(f"spread rank {rank} B2 {b2}: channel groups of {group} "
                f"on blockIdx.y")
            if rank == 2 and b2 in (6, 16):
                name = "spread_split_resident" if b2 == 6 else "spread_split"
                hold(name, kernel, plain, results)
                time_pair(name, kernel, plain, results, work)
            else:
                # Held, and timed beside its bound; not a main-path shape.
                extra = {}
                hold("spread_unplanned", kernel, plain, extra)
                ms = cuda_ms(kernel)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                log(f"time spread rank {rank} B2 {b2}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound "
                    f"{bound(*work)[0]:.4f} ms")
                if rank == 2:
                    res = results["spread_split"]
                    res["max_abs_err"] = max(res["max_abs_err"],
                                             extra["spread_unplanned"][
                                                 "max_abs_err"])
    return results


def mode_weights(grid, dtype, dev):
    """[rank, *grid] mode index k_a of each mode along each axis."""
    import torch
    axes = [torch.arange(n, dtype=dtype, device=dev) - n // 2 for n in grid]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def plain_loss_grads(source, points, data, transform_type):
    """0.5 |A source - data|^2 with A the forward NUFFT of
    ``transform_type``, and its gradients, through the plain pipelines
    (no autograd, no dispatch): the formulas of the port's backward, as
    the reference of the err_impl gates. Returns (r, g_source, g_points)."""
    import torch
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    rank = points.shape[1]
    grid = (tuple(source.shape[1:-1]) if transform_type == "type_2"
            else tuple(data.shape[1:-1]))
    dname = "complex128" if source.dtype == torch.float64 else "complex64"

    def plan(ttype, direction):
        return make_plan(PlanSpec(ttype, direction, rank, grid, dname, TOL,
                                  1))
    adjoint = "type_1" if transform_type == "type_2" else "type_2"
    r = plain_pipeline(source, points, plan(transform_type, "forward")) \
        - data
    g_source = plain_pipeline(r, points, plan(adjoint, "backward"))
    if transform_type == "type_2":
        w_grid, v_pts, direction = source, r, "forward"
    else:
        w_grid, v_pts, direction = r, source, "backward"
    batch = w_grid.shape[0]
    kw = mode_weights(grid, w_grid.dtype, w_grid.device)
    aux = plain_pipeline(
        (w_grid[:, None] * kw[None, ..., None]).reshape(
            (batch * rank,) + grid + (2,)), points,
        plan("type_2", direction)).reshape(batch, rank, -1, 2)
    vr, vi = v_pts[..., 0], v_pts[..., 1]
    if transform_type == "type_2":
        per = vi[:, None] * aux[..., 0] - vr[:, None] * aux[..., 1]
    else:
        per = vr[:, None] * aux[..., 1] - vi[:, None] * aux[..., 0]
    return r, g_source, -per.sum(dim=0).t()           # forward: sign -1


def impl_gates(label, grads, source, points, data, transform_type,
               route=None):
    """err_impl of the port's gradients against the float64 plain
    pipeline on the card, gated at max(tol, 4 * floor_f32), floor_f32
    being the float32 plain pipeline's error against it. With ``route``
    (the float64 route's source and points gradients), the port's are
    held to those at the same gates too, and they to the float64 plain
    pipeline's within 1e-9 of the peak. Returns the float64 gradients."""
    _, *ref = plain_loss_grads(source.double(), points.double(),
                               data.double(), transform_type)
    _, *f32 = plain_loss_grads(source, points, data, transform_type)
    failed = []
    for i, (what, got, want, low) in enumerate(zip(("source", "points"),
                                                   grads, ref, f32)):
        floor = rel(low, want)
        err = rel(got, want)
        gate = max(TOL, 4 * floor)
        log(f"{label} {what} grad: err_impl (vs f64 plain pipeline) "
            f"{err:.3e} (gate < {gate:.3e}; floor_f32 {floor:.3e})")
        if not err < gate:
            failed.append(what)
        if route is not None:
            err_route, agree = rel(got, route[i]), rel(route[i], want)
            log(f"{label} {what} grad: err_impl (vs float64 route) "
                f"{err_route:.3e} (gate < {gate:.3e}); float64 route vs "
                f"f64 plain pipeline {agree:.3e} (gate < 1e-9)")
            if not (err_route < gate and agree < 1e-9):
                failed.append(f"{what} (float64 route)")
    if failed:
        raise RuntimeError(f"{label}: err_impl gates failed: {failed}")
    return ref


def timed_step(label, fn, reps=STEP_REPS):
    """CUDA-event median of one forward + backward."""
    ms = cuda_ms(fn, reps=reps, warmup=1)
    log(f"time {label} (forward + backward): {ms:.4f} ms")
    return ms


def train_phase_2d(points, dev):
    """Trajectory learning at the 2D headline: a multicoil image x [8,
    256, 256, 2] and the points k [65536, 2], both learnable; loss 0.5
    |A(x; k) - y|^2, A the type-2 NUFFT, y made with a perturbed
    trajectory. Gates the step-1 gradients, times the steps, takes three
    Adam steps; then the planned form and a type-1 loss."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar
    grid = (GRID, GRID)
    rng = np.random.default_rng(SEED + 2)
    x0 = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH,) + grid + (2,)).astype(np.float32)).to(dev)
    k0 = torch.from_numpy(points).to(dev)
    k_true = k0 + torch.from_numpy(
        (SHIFT * rng.standard_normal(points.shape)).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = tnt.planar.nufft(x0, k_true, tol=TOL)

    def loss_fn(x, k):
        return 0.5 * (tnt.planar.nufft(x, k, tol=TOL) - y).square().sum()

    x = x0.clone().requires_grad_()
    k = k0.clone().requires_grad_()
    reset_launches()
    loss_fn(x, k).backward()
    torch.cuda.synchronize()
    launches = {"train2d": read_launches("train2d")}
    log(f"train2d type-2 step launches: {step_launches()}")
    gx, gk = x.grad.detach(), k.grad.detach()
    for name, g in (("x.grad", gx), ("k.grad", gk)):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"train2d {name} has non-finite values")

    # Exact: complex128 NUDFTs of the same formulas, x.grad on every
    # mode, k.grad on a seeded subset of points.
    k64 = k0.double()
    f = from_planar(x0).to(torch.complex128)
    r = exact2d_type2(f, k64, -1.0) - from_planar(y).to(torch.complex128)
    gx_exact = exact2d_type1(r, k64, 1.0)
    idx = torch.from_numpy(np.sort(np.random.default_rng(SEED + 4).choice(
        NUM_POINTS, SUBSET, replace=False))).to(dev)
    kw = mode_weights(grid, torch.float64, dev)
    gk_exact = torch.stack([torch.sum(torch.imag(
        torch.conj(r[:, idx]) * exact2d_type2(f * kw[a], k64[idx], -1.0)),
        dim=0) for a in range(2)], dim=-1)
    err_x = rel(from_planar(gx).to(torch.complex128), gx_exact)
    err_k = rel(gk[idx], gk_exact)
    log(f"train2d step 1: err_total x.grad (vs exact NUDFT) {err_x:.3e}, "
        f"k.grad ({SUBSET}-point subset) {err_k:.3e} (gate < {10 * TOL:g})")
    ref = impl_gates("train2d step 1", (gx, gk), x0, k0, y, "type_2")
    # The float64 plain pipeline against the same exact values: what the
    # algorithm itself reaches at this tol.
    log(f"train2d f64 plain pipeline: err_total x.grad "
        f"{rel(from_planar(ref[0]), gx_exact):.3e}, k.grad "
        f"{rel(ref[1][idx], gk_exact):.3e}")
    if not (err_x < 10 * TOL and err_k < 10 * TOL):
        raise RuntimeError("train2d: err_total gates failed")

    # The planned form: gradient for x only, through adjoint().
    op = tnt.PlannedNufft(k0, grid, transform_type="type_2", tol=TOL)

    def planned_loss(x):
        return 0.5 * (op(x) - y).square().sum()
    xq = x0.clone().requires_grad_()
    reset_launches()
    planned_loss(xq).backward()
    torch.cuda.synchronize()
    launches["train2d_planned"] = read_launches("train2d_planned")
    err_p = rel(from_planar(xq.grad).to(torch.complex128), gx_exact)
    err_pi = rel(xq.grad, ref[0])
    log(f"train2d planned x.grad: err_total {err_p:.3e} (gate < "
        f"{10 * TOL:g}), err_impl {err_pi:.3e}, vs unplanned "
        f"{rel(xq.grad, gx):.3e}")
    if not err_p < 10 * TOL:
        raise RuntimeError("train2d planned: err_total gate failed")

    steps = {
        "train2d_type2_step": lambda: loss_fn(x, k).backward(),
        "train2d_type2_x_only_step": lambda: loss_fn(x, k0).backward(),
        "train2d_planned_step": lambda: planned_loss(xq).backward(),
    }
    times = {name: timed_step(name, fn) for name, fn in steps.items()}

    # Three Adam steps on (x, k).
    x = x0.clone().requires_grad_()
    k = k0.clone().requires_grad_()
    opt = torch.optim.Adam([{"params": [x], "lr": LR_X},
                            {"params": [k], "lr": LR_K}])
    losses = []
    for step in range(3):
        opt.zero_grad()
        loss = loss_fn(x, k)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        log(f"train2d Adam step {step + 1}: loss {losses[-1]:.6e}")
    if not losses[2] < losses[0]:
        raise RuntimeError(f"train2d: the loss did not fall: {losses}")

    # One step of a type-1 loss (batch 3: B2 = 6 channels).
    c0 = torch.from_numpy(rng.standard_normal(
        (TYPE1_BATCH, NUM_POINTS, 2)).astype(np.float32)).to(dev)
    with torch.no_grad():
        target = tnt.planar.nufft(c0, k_true, grid_shape=grid,
                                  transform_type="type_1", tol=TOL)

    def loss1(c, k):
        return 0.5 * (tnt.planar.nufft(c, k, grid_shape=grid,
                                       transform_type="type_1", tol=TOL)
                      - target).square().sum()
    c = c0.clone().requires_grad_()
    k = k0.clone().requires_grad_()
    reset_launches()
    loss1(c, k).backward()
    torch.cuda.synchronize()
    launches["train2d_type1"] = read_launches("train2d_type1")
    log(f"train2d type-1 step launches: {step_launches()}")
    impl_gates("train2d type-1 step", (c.grad, k.grad), c0, k0, target,
               "type_1")
    times["train2d_type1_step"] = timed_step(
        "train2d_type1_step", lambda: loss1(c, k).backward())
    cases = dict(steps, train2d_type1_step=lambda: loss1(c, k).backward())
    return launches, cases


def train_phase_3d(points3, dev):
    """One forward + backward of the type-2 loss at the 3D headline
    (128^3 modes, 800,000 points, batch 1) with respect to x and k.
    err_total gates on 4096-element subsets take the port's residual r
    as given (an exact residual needs all points against all 2.1M
    modes): x.grad against the exact adjoint of r at 4096 modes, k.grad
    against the exact formula at 4096 points."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar
    rng = np.random.default_rng(SEED + 5)
    x0 = torch.from_numpy(rng.standard_normal(
        (1,) + GRID3 + (2,)).astype(np.float32)).to(dev)
    k0 = torch.from_numpy(points3).to(dev)
    k_true = k0 + torch.from_numpy((SHIFT * rng.standard_normal(
        points3.shape)).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = tnt.planar.nufft(x0, k_true, tol=TOL)
    x = x0.clone().requires_grad_()
    k = k0.clone().requires_grad_()

    def step():
        out = tnt.planar.nufft(x, k, tol=TOL)
        (0.5 * (out - y).square().sum()).backward()
        return out
    reset_launches()
    out = step()
    torch.cuda.synchronize()
    launches = read_launches("train3d")
    log(f"train3d step launches: {step_launches()}")
    gx, gk = x.grad.detach(), k.grad.detach()
    if not (bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gk).all())):
        raise RuntimeError("train3d: non-finite gradients")
    r = from_planar(out.detach() - y)[0].to(torch.complex128)    # [M]
    sub = np.random.default_rng(SEED + 6)
    idx_modes = torch.from_numpy(np.sort(sub.choice(
        int(np.prod(GRID3)), SUBSET, replace=False))).to(dev)
    idx_pts = torch.from_numpy(np.sort(sub.choice(
        NUM_POINTS3, SUBSET, replace=False))).to(dev)
    gx_exact = exact_type1_subset(points3, r, idx_modes, dev, sign=1.0)
    f = from_planar(x0)[0].to(torch.complex128)
    kw = mode_weights(GRID3, torch.float64, dev)
    gk_exact = torch.stack([torch.imag(torch.conj(r[idx_pts])
                                       * exact_type2_subset(
                                           points3, f * kw[a], idx_pts,
                                           -1.0, dev))
                            for a in range(3)], dim=-1)
    ref = impl_gates("train3d", (gx, gk), x0, k0, y, "type_2")
    scale_x = float(from_planar(ref[0]).abs().max())
    err_x = float((from_planar(gx)[0].reshape(-1)[idx_modes]
                   .to(torch.complex128) - gx_exact).abs().max()) / scale_x
    err_k = rel(gk[idx_pts], gk_exact, float(ref[1].abs().max()))
    log(f"train3d: err_total x.grad ({SUBSET} modes, given r) {err_x:.3e}, "
        f"k.grad ({SUBSET} points, given r) {err_k:.3e} (gate < "
        f"{10 * TOL:g})")
    if not (err_x < 10 * TOL and err_k < 10 * TOL):
        raise RuntimeError("train3d: err_total gates failed")
    timed_step("train3d_type2_step", step, reps=3)
    return launches, {"train3d_type2_step": step}


def plain_spread_only(source, points, plan):
    """A spread-only op through the plain versions (any dtype, no
    dispatch, no autograd): source [B, M, 2] -> [B, *grid, 2] (type-1)
    or [B, *grid, 2] -> [B, M, 2] (type-2)."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import (binning, interp, mode3d,
                                                    spread)
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    geom, binned = bin_for_plan(points, plan)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    batch = source.shape[0]
    if plan.spec.transform_type == "type_1":
        values = binning.build_values_payload(
            source.movedim(-1, 1).reshape(2 * batch, -1), binned)
        tiles = spread.spread_tiles_plain(values, tb, geom, plan,
                                          coords=coords)
        out = torch.view_as_real(mode3d.fold_plain(tiles, geom, batch))
    else:
        tiles = mode3d.extend_plain(torch.view_as_complex(
            source.contiguous()), geom)
        chunk_vals = interp.interp_tiles_plain(tiles, tb, geom, plan,
                                               coords=coords)
        flat = chunk_vals.transpose(0, 1).reshape(2 * batch, -1)
        out = binning.scatter_chunked(flat, binned).reshape(
            batch, 2, -1).movedim(1, -1)
    return out * plan.kernel_scale


def fd_gate(label, k_grad, points, terms, step=FD_STEP, spread_only=True):
    """The points gradient against a float64 central difference of the
    plain spread-only ops (or, without ``spread_only``, of the plain
    pipeline of the transform) at FD_POINTS seeded points, each alone (a
    point's gradient depends on no other point), with a difference step
    of ``step`` rad. terms: (type, source, cotangent, grid) of the summed
    losses sum(cotangent * op(source[:, j], k_j))."""
    import torch
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    rank = points.shape[1]
    op = plain_spread_only if spread_only else plain_pipeline
    js = np.random.default_rng(SEED + 7).choice(points.shape[0], FD_POINTS,
                                                replace=False)
    worst = 0.0
    for j in js:
        for a in range(rank):
            fd = 0.0
            for ttype, src, ct, grid in terms:
                plan = make_plan(PlanSpec(ttype, "forward", rank, grid,
                                          "complex128", TOL, 1,
                                          spread_only=spread_only))
                s = src.double() if ttype == "type_2" else \
                    src[:, j:j + 1].double()
                c = ct[:, j:j + 1].double() if ttype == "type_2" else \
                    ct.double()
                for sign in (1.0, -1.0):
                    kj = points[j:j + 1].double().clone()
                    kj[0, a] += sign * step
                    fd += sign * float(torch.sum(c * op(s, kj, plan))) \
                        / (2 * step)
            worst = max(worst, abs(fd - float(k_grad[j, a])))
    scale = float(k_grad.abs().max())
    log(f"{label} k.grad vs f64 central difference at {FD_POINTS} points: "
        f"max |diff| {worst:.3e} (gate < {FD_RTOL:g} * {scale:.3e})")
    if not worst < FD_RTOL * scale:
        raise RuntimeError(f"{label}: points gradient misses its finite "
                           f"difference")


def spread_only_phase(points, grid, dev, cpu_reference):
    """tnt.planar.interp and tnt.planar.spread on the fine grid ``grid``
    with ``points``, forward and backward (source and points). Gates:
    finite values; with ``cpu_reference``, the same calls on CPU tensors
    (the plain versions) to 1e-5 of the peak; the points gradients
    against a float64 finite difference of the plain ops."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    rank = len(grid)
    phase = f"spread_only_{rank}d"
    rng = np.random.default_rng(SEED + 8)
    m = points.shape[0]

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    host = (torch.from_numpy(points), draw((1,) + grid + (2,)),
            draw((1, m, 2)), draw((1, m, 2)), draw((1,) + grid + (2,)))
    placed = {"cpu": host, dev: tuple(t.to(dev) for t in host)}

    def run(device):
        pts, g, w, c, wg = placed[device]
        k, gg, cc = (t.clone().requires_grad_() for t in (pts, g, c))
        v = tnt.planar.interp(gg, k, tol=TOL)
        f = tnt.planar.spread(cc, k, grid, tol=TOL)
        (torch.sum(v * w) + torch.sum(f * wg)).backward()
        return [t.detach() for t in (v, f, gg.grad, cc.grad, k.grad)]
    reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    launches = read_launches(phase)
    for name, t in zip(("interp", "spread", "grid.grad", "values.grad",
                        "k.grad"), got):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{phase} {name} has non-finite values")
    if cpu_reference:
        want = run("cpu")
        for name, a, b in zip(("interp", "spread", "grid.grad",
                               "values.grad", "k.grad"), got, want):
            err = rel(a.cpu(), b)
            log(f"{phase} {name}: vs CPU plain versions {err:.3e} "
                f"(gate < {KERNEL_RTOL:g})")
            if not err <= KERNEL_RTOL:
                raise RuntimeError(f"{phase} {name} disagrees with the "
                                   f"plain versions")
    pts, g, w, c, wg = placed[dev]
    # The step in grid units of the 2D phase (FD_STEP on 512 cells): a
    # step of FD_STEP rad is 3.3 cells of the 1D headline's 2^21.
    step = FD_STEP * min(1.0, 512 / max(grid))
    fd_gate(phase, got[4], pts, (("type_2", g, w, grid),
                                 ("type_1", c, wg, grid)), step)
    timed_step(f"{phase}_step", lambda: run(dev), reps=3)
    return launches, {f"{phase}_step": lambda: run(dev)}


# ---------------------------------------------------------------------------
# Rank 1 (1D).
# ---------------------------------------------------------------------------

GRID1 = 2 ** 20
NUM_POINTS1 = 10_000_000
# The 1D geometry the port's choose_geometry gives at GRID1 / NUM_POINTS1.
GEOMETRY1 = dict(fine_shape=(2 ** 21,), tile=(1024,), ext=(1032,),
                 tiles=(2048,), chunk=256, num_chunks=41110)
MATS_GRID1 = 65_536
MATS_POINTS1 = 16_384
TRAIN_BATCH1 = 4     # B2 = 8: the source gradient's spread


def inputs1d():
    """The 1D headline's points, type-1 strengths and type-2 modes (seed
    42)."""
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-np.pi, np.pi, (NUM_POINTS1, 1)).astype(np.float32)
    z = (rng.standard_normal(NUM_POINTS1)
         + 1j * rng.standard_normal(NUM_POINTS1)).astype(np.complex64)
    modes = (rng.standard_normal(GRID1)
             + 1j * rng.standard_normal(GRID1)).astype(np.complex64)
    return points, z, modes


@contextlib.contextmanager
def no_plain_calls(label):
    """Counts the calls of the spread and interp plain versions while a
    card path runs (the dispatcher reaches them through their module),
    and fails if there was one."""
    from tensorflow_nufft_tpu_torch.kernels import interp, spread
    saved = spread.spread_tiles_plain, interp.interp_tiles_plain
    calls = []

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper
    spread.spread_tiles_plain, interp.interp_tiles_plain = map(counted,
                                                               saved)
    try:
        yield
    finally:
        spread.spread_tiles_plain, interp.interp_tiles_plain = saved
    log(f"{label}: plain-version calls on the card path: {len(calls)}")
    if calls:
        raise RuntimeError(f"{label}: the card path ran plain versions "
                           f"{sorted(set(calls))}")


def repeat(name, kernel):
    """Fails unless two calls of ``kernel`` are equal bit for bit."""
    import torch
    if not torch.equal(kernel(), kernel()):
        raise RuntimeError(f"{name} does not repeat bit for bit")
    log(f"kernel {name}: repeats bit for bit")


def kernel_phase_1d(points, dev):
    """The rank-1 spread, interp and phi' interp at the 1D headline
    geometry (B2 = 2) against their plain versions, repeated bit for
    bit, and timed; the spread also from slot-order values (row 6: the
    binned plan's normal and apply_from_slots); the spread and interp
    at B2 = 8 (the type-2 training step's)."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    plan = make_plan(PlanSpec("type_1", "forward", 1, (GRID1,), "complex64",
                              TOL, 1))
    geom, binned = bin_for_plan(torch.from_numpy(points).to(dev), plan)
    got_geom = {k: getattr(geom, k) for k in GEOMETRY1}
    tb = binned.tile_bounds
    used = int(tb[-1]) * geom.chunk
    log(f"1D plan: width {plan.width} fine {plan.fine_shape}; geometry "
        f"{got_geom}; used chunks {int(tb[-1])}; spread launch "
        f"{spread.launch_shape(geom, 2, plan.width)} (group, warps, lines, "
        f"threads, smem), at B2 = 8 "
        f"{spread.launch_shape(geom, 8, plan.width)}; interp launch "
        f"{interp.launch_shape(geom, 2)} (group, slab, slots, threads, "
        f"smem), at B2 = 8 {interp.launch_shape(geom, 8)}")
    if got_geom != GEOMETRY1:
        raise RuntimeError(f"1D geometry {got_geom} != {GEOMETRY1}")
    coords = binning.build_coords_payload(binned)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values_pl = binning.build_values_payload(
        torch.randn((2, NUM_POINTS1), generator=gen, device=dev), binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    values8 = binning.build_values_payload(
        torch.randn((8, NUM_POINTS1), generator=gen, device=dev), binned)
    tiles8 = torch.randn(geom.tiles + (8,) + geom.ext, generator=gen,
                         device=dev)
    # Slot-order values as the binned plan's normal feeds them: the
    # chunk-order interp of tiles (zero in padded and unused slots).
    slots = interp.interp_tiles_plain(tiles, tb, geom, plan, coords=coords)
    slots = slots.transpose(0, 1).reshape(2, -1)
    slots = (slots / slots.abs().max()).contiguous()
    wrap = wrappers()
    cases = {
        "spread_unplanned_1d": (
            functools.partial(wrap["spread_unplanned_1d"], values_pl, tb,
                              geom, plan, coords),
            functools.partial(spread.spread_tiles_plain, values_pl, tb,
                              geom, plan, coords=coords), "spread"),
        "spread_split_1d": (
            functools.partial(wrap["spread_split_1d"], slots, tb, geom,
                              plan, coords),
            functools.partial(spread.spread_tiles_plain, slots, tb, geom,
                              plan, coords=coords), "spread"),
        "interp_unplanned_1d": (
            functools.partial(wrap["interp_unplanned_1d"], tiles, tb, geom,
                              plan, coords),
            functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                              plan, coords=coords), "interp"),
        "interp_deriv_1d": (
            functools.partial(wrap["interp_deriv_1d"], tiles, tb, geom,
                              plan, coords, 0),
            functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                              plan, coords=coords, deriv_axis=0), "interp"),
        "spread_unplanned_1d_b8": (
            functools.partial(wrap["spread_unplanned_1d_b8"], values8, tb,
                              geom, plan, coords),
            functools.partial(spread.spread_tiles_plain, values8, tb, geom,
                              plan, coords=coords), "spread"),
        "interp_unplanned_1d_b8": (
            functools.partial(wrap["interp_unplanned_1d_b8"], tiles8, tb,
                              geom, plan, coords),
            functools.partial(interp.interp_tiles_plain, tiles8, tb, geom,
                              plan, coords=coords), "interp"),
    }
    results = {}
    for name, (kernel, plain, kind) in cases.items():
        b2 = 8 if name.endswith("_b8") else 2
        hold(name, kernel, plain, results)
        repeat(name, kernel)
        time_pair(name, kernel, plain, results,
                  tile_work(kind, False, geom, plan, b2, NUM_POINTS1, used))
    return results


def end_to_end_1d(points, z, modes, dev):
    """The 1D main path at the headline: PlannedNufft type-1 (the binned
    level) and its adjoint, planar.nufft type-1 and type-2, with launch
    counting and no plain-version call; gates err_total against
    complex128 NUDFTs on 4096-element subsets and err_impl against the
    float64 plain pipeline (floor_gates: the bare gates, or 4x the float32
    plain pipeline's own errors where it misses them); reports the
    binade crossing of tile 0's kernel argument."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
        fold_and_rescale_split)
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    grid = (GRID1,)
    pts = torch.from_numpy(points).to(dev)
    strengths = to_planar(z).to(dev)
    modes_p = to_planar(modes).to(dev)
    reset_launches()
    with no_plain_calls("1d"):
        op1 = tnt.PlannedNufft(pts, grid, transform_type="type_1", tol=TOL)
        adj = op1.adjoint()                    # type-2, backward
        outs = {
            "t1_planned": op1(strengths[None])[0],
            "t2_planned": adj(modes_p[None])[0],
            "t1_unplanned": tnt.planar.nufft(
                strengths, pts, grid_shape=grid, transform_type="type_1",
                tol=TOL),
            "t2_unplanned": tnt.planar.nufft(
                modes_p, pts, transform_type="type_2",
                fft_direction="backward", tol=TOL)}
        torch.cuda.synchronize()
    g = op1.geom
    log(f"1D plan level {op1.level}: tiles {g.tiles} x {g.tile} ext {g.ext} "
        f"chunk {g.chunk} chunks {g.num_chunks} (used "
        f"{int(op1.binned.tile_bounds[-1])}); num_slots {op1.num_slots}")
    if op1.level != "binned":
        raise RuntimeError("the 1D headline plan did not take the binned "
                           "level")
    launches = read_launches("1d")
    for name, out in outs.items():
        expect = grid + (2,) if name.startswith("t1") else (NUM_POINTS1, 2)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"1D {name}: shape {tuple(out.shape)} (want "
                               f"{expect}) or non-finite values")
    log(f"1D planned vs unplanned max abs diff: type-1 "
        f"{float((outs['t1_planned'] - outs['t1_unplanned']).abs().max()):.3e}"
        f", type-2 "
        f"{float((outs['t2_planned'] - outs['t2_unplanned']).abs().max()):.3e}")
    sub = np.random.default_rng(SEED + 21)
    idx = {"t1": torch.from_numpy(np.sort(sub.choice(
               GRID1, SUBSET, replace=False))).to(dev),
           "t2": torch.from_numpy(np.sort(sub.choice(
               NUM_POINTS1, SUBSET, replace=False))).to(dev)}
    exact = {"t1": exact_type1_subset(points, z, idx["t1"], dev, grid=grid),
             "t2": exact_type2_subset(points, modes, idx["t2"], 1.0, dev,
                                      grid=grid)}
    # Points whose tile-origin kernel argument s = hi - origin crosses a
    # binade in tile 0 (origin -4): hi in [1020, 1024).
    hi = fold_and_rescale_split(pts, g.fine_shape, 1)[0][:, 0]
    near = (hi >= 1020) & (hi < 1024)
    failed = []
    for key, ttype, direction, src in (
            ("t1", "type_1", "forward", strengths),
            ("t2", "type_2", "backward", modes_p)):
        spec = dict(transform_type=ttype, fft_direction=direction, rank=1,
                    grid_shape=grid, tol=TOL, points_range=1)
        ref = from_planar(plain_pipeline(
            src[None].double(), pts.double(),
            make_plan(PlanSpec(dtype_name="complex128", **spec)))[0])
        f32 = from_planar(plain_pipeline(
            src[None], pts, make_plan(PlanSpec(dtype_name="complex64",
                                               **spec)))[0])
        for name in (f"{key}_planned", f"{key}_unplanned"):
            if not floor_gates(f"1D {name} ({GRID1} modes, {NUM_POINTS1} "
                               f"points, {SUBSET} subset)",
                               from_planar(outs[name]), f32, ref,
                               exact[key], idx[key]):
                failed.append(name)
        if key == "t2":
            scale = float(ref.abs().max())
            diff = (from_planar(outs["t2_unplanned"]).to(torch.complex128)
                    - ref).abs()
            low = (f32.to(torch.complex128) - ref).abs()
            there = float(diff[near].max()) / scale if near.any() else 0.0
            log(f"1D binade crossing in tile 0 (hi in [1020, 1024)): "
                f"{int(near.sum())} points, err_impl there {there:.3e} "
                f"(f32 plain pipeline {float(low[near].max()) / scale:.3e}"
                f"), elsewhere {float(diff[~near].max()) / scale:.3e}; "
                f"shows above tol: {there > TOL}")
        del ref, f32
    if failed:
        raise RuntimeError(f"1D accuracy gates failed: {failed}")
    cases = transform_cases(op1, adj, pts, strengths, modes_p, grid,
                            dict(fft_direction="backward"))
    for name, fn in cases.items():
        ms = cuda_ms(fn, reps=10)
        log(f"time 1d_{name}: {ms:.4f} ms"
            + ("" if name == "plan_build" else
               f" per transform, {NUM_POINTS1 / (ms * 1e-3):.4e} points/s"))
    return launches, op1, adj, pts, strengths, modes_p


def planned_mats_phase_1d(points, dev):
    """The 1D mats size: 65,536 modes and the first 16,384 headline
    points, where the JAX plan keeps its dense matrices (193.5 MiB) and
    its tile array stays resident (TPU rows 1, 2 and 10). A planned
    type-1, its adjoint and an unplanned type-1 with launch counting,
    held to the unplanned transforms; the planned surface of that plan
    and of the binned plan at the same size (the budget lowered, as the
    JAX package's per-plan payload budget of its batched plans does: its
    slot-order spread is row 5); the kernels held to their plain versions
    and timed."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    rng = np.random.default_rng(SEED + 22)
    m, grid = MATS_POINTS1, (MATS_GRID1,)
    pts = torch.from_numpy(points[:m]).to(dev)
    strengths = torch.from_numpy(rng.standard_normal((1, m, 2)).astype(
        np.float32)).to(dev)
    modes = torch.from_numpy(rng.standard_normal((1,) + grid + (2,)).astype(
        np.float32)).to(dev)
    phases = {}
    reset_launches()
    with no_plain_calls("1d_mats"):
        op = tnt.PlannedNufft(pts, grid, transform_type="type_1", tol=TOL)
        t1 = op(strengths)
        t2 = op.adjoint()(modes)
        u1 = tnt.planar.nufft(strengths, pts, grid_shape=grid,
                              transform_type="type_1", tol=TOL)
        torch.cuda.synchronize()
    geom = op.geom
    log(f"1d_mats plan level {op.level}: tiles {geom.tiles} ext {geom.ext} "
        f"chunk {geom.chunk} chunks {geom.num_chunks} (used "
        f"{int(op.binned.tile_bounds[-1])}); dense matrices of the JAX "
        f"plan {binning.mats_payload_bytes(geom):.4e} B")
    if op.level != "mats":
        raise RuntimeError("the 1D mats-size plan did not take the mats "
                           "level")
    phases["1d_mats"] = read_launches("1d_mats")
    u2 = tnt.planar.nufft(modes, pts, fft_direction="backward", tol=TOL)
    for name, got, want in (("type-1", t1, u1), ("type-2", t2, u2)):
        err = rel(got, want)
        log(f"1d_mats {name}: planned vs unplanned {err:.3e} (gate < "
            f"{KERNEL_RTOL:g})")
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"1d_mats {name} disagrees with the unplanned "
                               f"transform")
    density = torch.linalg.norm(pts, dim=1)
    with no_plain_calls("1d_mats_slots"):
        phases["1d_mats_slots"] = slots_phase(
            "1d mats level", op.adjoint(), modes, strengths, density,
            "1d_mats_slots")
    budget = binning.MATS_BYTES_BUDGET
    binning.MATS_BYTES_BUDGET = 0
    try:
        binned_op = tnt.PlannedNufft(pts, grid, transform_type="type_2",
                                     fft_direction="backward", tol=TOL)
    finally:
        binning.MATS_BYTES_BUDGET = budget
    if binned_op.level != "binned":
        raise RuntimeError("the lowered budget did not give the binned "
                           "level")
    with no_plain_calls("1d_binned_slots"):
        phases["1d_binned_slots"] = slots_phase(
            "1d binned level at the mats size", binned_op, modes, strengths,
            density, "1d_binned_slots")
    kw, tb = op.weights, op.binned.tile_bounds
    used = int(tb[-1]) * geom.chunk
    coords = binning.build_coords_payload(op.binned)
    values_pl = binning.build_values_payload(
        strengths[0].t().contiguous(), op.binned)
    tiles = torch.from_numpy(rng.standard_normal(
        geom.tiles + (2,) + geom.ext).astype(np.float32)).to(dev)
    slots = interp.interp_tiles_plain(tiles, tb, geom, op.plan,
                                      coords=coords)
    slots = slots.transpose(0, 1).reshape(2, -1)
    slots = (slots / slots.abs().max()).contiguous()
    results = {}
    wrap = wrappers()
    for name, kernel, plain, kind, planned in (
            ("spread_planned_1d",
             functools.partial(wrap["spread_planned_1d"], values_pl, tb,
                               geom, op.plan, kw),
             functools.partial(spread.spread_tiles_plain, values_pl, tb,
                               geom, op.plan, kw=kw), "spread", True),
            ("interp_planned_1d",
             functools.partial(wrap["interp_planned_1d"], tiles, tb, geom,
                               op.plan, kw),
             functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                               op.plan, kw=kw), "interp", True),
            ("spread_resident_1d",
             functools.partial(wrap["spread_resident_1d"], values_pl, tb,
                               geom, op.plan, coords),
             functools.partial(spread.spread_tiles_plain, values_pl, tb,
                               geom, op.plan, coords=coords), "spread",
             False),
            ("spread_split_resident_1d",
             functools.partial(wrap["spread_split_resident_1d"], slots, tb,
                               geom, op.plan, coords),
             functools.partial(spread.spread_tiles_plain, slots, tb, geom,
                               op.plan, coords=coords), "spread", False)):
        hold(name, kernel, plain, results)
        repeat(name, kernel)
        time_pair(name, kernel, plain, results,
                  tile_work(kind, planned, geom, op.plan, 2, m, used))
    return phases, results


def train_phase_1d(points, dev):
    """Training at the 1D headline points: a type-2 loss with x [4, 2^20,
    2] and k [10^7, 1] learnable (the source gradient spreads B2 = 8
    channels), gated as the 3D training step (err_total on 4096-element
    subsets given the port's residual, err_impl against the float64 plain
    pipeline); then one batch-3 type-1 loss step (B2 = 6), gated on
    err_impl. Launch counts per step, no plain-version call, times."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch.planar import from_planar
    grid = (GRID1,)
    rng = np.random.default_rng(SEED + 23)
    x0 = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH1,) + grid + (2,)).astype(np.float32)).to(dev)
    k0 = torch.from_numpy(points).to(dev)
    k_true = k0 + torch.from_numpy((SHIFT * rng.standard_normal(
        points.shape)).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = tnt.planar.nufft(x0, k_true, tol=TOL)
    x = x0.clone().requires_grad_()
    k = k0.clone().requires_grad_()

    def step():
        out = tnt.planar.nufft(x, k, tol=TOL)
        (0.5 * (out - y).square().sum()).backward()
        return out
    reset_launches()
    with no_plain_calls("train1d"):
        out = step()
        torch.cuda.synchronize()
    launches = {"train1d": read_launches("train1d")}
    log(f"train1d type-2 step launches: {step_launches()}")
    gx, gk = x.grad.detach(), k.grad.detach()
    if not (bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gk).all())):
        raise RuntimeError("train1d: non-finite gradients")
    r = from_planar(out.detach() - y).to(torch.complex128)       # [B, M]
    sub = np.random.default_rng(SEED + 24)
    idx_modes = torch.from_numpy(np.sort(sub.choice(
        GRID1, SUBSET, replace=False))).to(dev)
    idx_pts = torch.from_numpy(np.sort(sub.choice(
        NUM_POINTS1, SUBSET, replace=False))).to(dev)
    # x.grad of the first image at 4096 modes; k.grad at 4096 points.
    gx_exact = exact_type1_subset(points, r[0], idx_modes, dev, sign=1.0,
                                  grid=grid)
    f = from_planar(x0).to(torch.complex128)
    kw = mode_weights(grid, torch.float64, dev)[0]
    gk_exact = sum(torch.imag(torch.conj(r[b, idx_pts]) * exact_type2_subset(
        points, f[b] * kw, idx_pts, -1.0, dev, grid=grid))
        for b in range(TRAIN_BATCH1))[:, None]
    ref = impl_gates("train1d", (gx, gk), x0, k0, y, "type_2")
    scale_x = float(from_planar(ref[0]).abs().max())
    err_x = float((from_planar(gx)[0][idx_modes].to(torch.complex128)
                   - gx_exact).abs().max()) / scale_x
    err_k = rel(gk[idx_pts], gk_exact, float(ref[1].abs().max()))
    log(f"train1d: err_total x.grad ({SUBSET} modes of image 0, given r) "
        f"{err_x:.3e}, k.grad ({SUBSET} points, given r) {err_k:.3e} (gate "
        f"< {10 * TOL:g})")
    if not (err_x < 10 * TOL and err_k < 10 * TOL):
        raise RuntimeError("train1d: err_total gates failed")
    del ref, r, f
    cases = {"train1d_type2_step": step}
    timed_step("train1d_type2_step", step, reps=3)

    c0 = torch.from_numpy(rng.standard_normal(
        (TYPE1_BATCH, NUM_POINTS1, 2)).astype(np.float32)).to(dev)
    with torch.no_grad():
        target = tnt.planar.nufft(c0, k_true, grid_shape=grid,
                                  transform_type="type_1", tol=TOL)
    c = c0.clone().requires_grad_()
    k1 = k0.clone().requires_grad_()

    def step1():
        out = tnt.planar.nufft(c, k1, grid_shape=grid,
                               transform_type="type_1", tol=TOL)
        (0.5 * (out - target).square().sum()).backward()
    reset_launches()
    with no_plain_calls("train1d_type1"):
        step1()
        torch.cuda.synchronize()
    launches["train1d_type1"] = read_launches("train1d_type1")
    log(f"train1d type-1 step launches: {step_launches()}")
    impl_gates("train1d type-1 step", (c.grad, k1.grad), c0, k0, target,
               "type_1")
    timed_step("train1d_type1_step", step1, reps=3)
    cases["train1d_type1_step"] = step1
    return launches, cases


# ---------------------------------------------------------------------------
# The complex API, the float64 route and CG-SENSE.
# ---------------------------------------------------------------------------

def no_launches(label):
    """Fails unless no kernel launched since the last reset_launches()."""
    ran = {name: n for name, n in step_launches().items() if n}
    log(f"{label}: kernel launches {ran or 0}")
    if ran:
        raise RuntimeError(f"{label} launched kernels {ran}")


def same_as_planar(label, got, want):
    """Holds ``view_as_real(got)`` to the planar API's output ``want``:
    bit for bit, or else (logged) within 1e-6 of the peak."""
    import torch
    got = torch.view_as_real(got)
    if torch.equal(got, want):
        log(f"{label}: equals the planar API bit for bit")
        return
    err = rel(got, want)
    log(f"{label}: NOT bit for bit the planar API: {err:.3e} of the peak "
        f"(gate < 1e-6)")
    if not err < 1e-6:
        raise RuntimeError(f"{label} disagrees with the planar API")


def complex_phase_2d(points, z, modes, dev):
    """The complex API at the 2D headline: complex64 nufft type-1 and
    type-2 in both directions, interp and spread on the 512^2 grid, and a
    training step (x [8, 256, 256] and k, loss.backward(), then the
    spread-only points gradient), counted as one main path; then each
    held to the planar API, the transforms to the exact NUDFT (< 10 * tol)
    and to the complex128 transform on the card (the float64 route, <
    tol), and the complex128 transforms at tol 1e-6 and 1e-12 (exact
    NUDFT; at 1e-12 on 4096-element subsets, < 1e-10) with no kernel
    launch."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    grid, fine = (GRID, GRID), (2 * GRID, 2 * GRID)
    rng = np.random.default_rng(SEED + 12)
    pts = torch.from_numpy(points).to(dev)
    c = torch.from_numpy(z).to(dev)
    f = torch.from_numpy(modes).to(dev)
    def normal(shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape)).astype(
                                     np.complex64)).to(dev)
    g = normal(fine)
    x0 = normal((TRAIN_BATCH,) + grid)
    y = normal((TRAIN_BATCH, NUM_POINTS))
    dirs = (("forward", -1.0), ("backward", 1.0))

    def transforms():
        out = {}
        for direction, _ in dirs:
            out[("type_1", direction)] = tnt.nufft(
                c, pts, grid_shape=grid, transform_type="type_1",
                fft_direction=direction, tol=TOL)
            out[("type_2", direction)] = tnt.nufft(
                f, pts, fft_direction=direction, tol=TOL)
        return out

    def step(x, k):
        r = torch.view_as_real(tnt.nufft(x, k, tol=TOL) - y)
        loss = 0.5 * r.square().sum() + torch.view_as_real(
            tnt.interp(g, k, tol=TOL)).square().sum()
        loss.backward()

    x = x0.clone().requires_grad_()
    k = pts.clone().requires_grad_()
    reset_launches()
    outs = transforms()
    interp_out = tnt.interp(g, pts, tol=TOL)
    spread_out = tnt.spread(c, pts, fine, tol=TOL)
    step(x, k)
    torch.cuda.synchronize()
    launches = read_launches("complex2d")
    log(f"complex2d launches: {step_launches()}")

    for (ttype, direction), out in outs.items():
        src = c if ttype == "type_1" else f
        same_as_planar(f"complex2d {ttype} {direction}", out,
                       tnt.planar.nufft(
                           torch.view_as_real(src), pts,
                           grid_shape=grid if ttype == "type_1" else None,
                           transform_type=ttype, fft_direction=direction,
                           tol=TOL))
    same_as_planar("complex2d interp", interp_out, tnt.planar.interp(
        torch.view_as_real(g), pts, tol=TOL))
    same_as_planar("complex2d spread", spread_out, tnt.planar.spread(
        torch.view_as_real(c), pts, fine, tol=TOL))
    xp = torch.view_as_real(x0).clone().requires_grad_()
    kp = pts.clone().requires_grad_()
    yp = torch.view_as_real(y)
    loss = 0.5 * (tnt.planar.nufft(xp, kp, tol=TOL) - yp).square().sum()
    loss = loss + tnt.planar.interp(torch.view_as_real(g), kp,
                                    tol=TOL).square().sum()
    loss.backward()
    for name, got, want in (("x.grad", torch.view_as_real(x.grad), xp.grad),
                            ("k.grad", k.grad, kp.grad)):
        err = rel(got, want)
        log(f"complex2d step {name}: vs the planar API {err:.3e} of the "
            f"peak (gate < 1e-6)")
        if not (bool(torch.isfinite(got).all()) and err < 1e-6):
            raise RuntimeError(f"complex2d step {name} disagrees with the "
                               f"planar API")

    x64 = pts.double()
    c64, f64 = c.to(torch.complex128), f.to(torch.complex128)
    reset_launches()
    refs = {}
    for direction, _ in dirs:
        refs[("type_1", direction)] = tnt.nufft(
            c64, x64, grid_shape=grid, transform_type="type_1",
            fft_direction=direction, tol=TOL)
        refs[("type_2", direction)] = tnt.nufft(
            f64, x64, fft_direction=direction, tol=TOL)
    tight = {"type_1": tnt.nufft(c64, x64, grid_shape=grid,
                                 transform_type="type_1", tol=1e-12),
             "type_2": tnt.nufft(f64, x64, tol=1e-12)}
    torch.cuda.synchronize()
    no_launches("complex2d float64 route")
    failed = []
    for (ttype, direction), out in outs.items():
        sign = dict(dirs)[direction]
        exact = (exact2d_type1(c64[None], x64, sign, GRID)
                 if ttype == "type_1"
                 else exact2d_type2(f64[None], x64, sign, GRID))[0]
        ref = refs[(ttype, direction)]
        err_total, err_impl = rel(out, exact), rel(out, ref,
                                                   float(exact.abs().max()))
        err64 = rel(ref, exact)
        log(f"complex2d {ttype} {direction}: err_total {err_total:.3e} "
            f"(gate < {10 * TOL:g}), err_impl (vs complex128 on the card) "
            f"{err_impl:.3e} (gate < {TOL:g}); complex128 err_total "
            f"{err64:.3e} (gate < {10 * TOL:g})")
        if not (err_total < 10 * TOL and err_impl < TOL
                and err64 < 10 * TOL):
            failed.append((ttype, direction))
    sub = np.random.default_rng(SEED + 13)
    idx1 = torch.from_numpy(np.sort(sub.choice(GRID * GRID, SUBSET,
                                               replace=False))).to(dev)
    idx2 = torch.from_numpy(np.sort(sub.choice(NUM_POINTS, SUBSET,
                                               replace=False))).to(dev)
    exact1 = exact_type1_subset(x64, c64, idx1, dev, grid=grid)
    exact2 = exact_type2_subset(x64, f64, idx2, -1.0, dev, grid=grid)
    for ttype, got, exact in (
            ("type_1", tight["type_1"].reshape(-1)[idx1], exact1),
            ("type_2", tight["type_2"][idx2], exact2)):
        err = rel(got, exact)
        log(f"complex2d complex128 {ttype} at tol 1e-12: err_total "
            f"({SUBSET}-element subset) {err:.3e} (gate < 1e-10)")
        if not err < 1e-10:
            failed.append((ttype, "1e-12"))
    if failed:
        raise RuntimeError(f"complex2d gates failed: {failed}")
    cases = {
        "complex_t1": lambda: tnt.nufft(c, pts, grid_shape=grid,
                                        transform_type="type_1", tol=TOL),
        "complex_t2": lambda: tnt.nufft(f, pts, tol=TOL),
        "complex128_t1": lambda: tnt.nufft(
            c64, x64, grid_shape=grid, transform_type="type_1", tol=TOL),
        "complex128_t2": lambda: tnt.nufft(f64, x64, tol=TOL),
        "complex_step": lambda: step(x0.clone().requires_grad_(),
                                     pts.clone().requires_grad_()),
    }
    for name, fn in cases.items():
        log(f"time complex2d {name}: {cuda_ms(fn, reps=10):.4f} ms")
    return launches, cases


def complex_phase_3d(points3, z3, modes3, dev):
    """The complex API at the 3D headline: complex64 nufft type-1 and
    type-2, counted, each equal to the planar API's."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    pts = torch.from_numpy(points3).to(dev)
    c = torch.from_numpy(z3).to(dev)
    f = torch.from_numpy(modes3).to(dev)
    reset_launches()
    t1 = tnt.nufft(c, pts, grid_shape=GRID3, transform_type="type_1",
                   tol=TOL)
    t2 = tnt.nufft(f, pts, tol=TOL)
    torch.cuda.synchronize()
    launches = read_launches("complex3d")
    same_as_planar("complex3d type_1", t1, tnt.planar.nufft(
        torch.view_as_real(c), pts, grid_shape=GRID3,
        transform_type="type_1", tol=TOL))
    same_as_planar("complex3d type_2", t2, tnt.planar.nufft(
        torch.view_as_real(f), pts, tol=TOL))
    return launches


# bench_suite.py's cg_sense_10iter_128_8coil_radial cells.
CG_GRID = (128, 128)
CG_COILS = 8
CG_SPOKES, CG_SAMPLES = 128, 256
CG_ITERS = 10
CG_RTOL = 2e-3


def cg_sense_phase(dev):
    """CG-SENSE at bench_suite.py's cell: 128^2 image, 8 birdcage coils,
    128 radial spokes of 256 samples, the ramp density, the Shepp-Logan
    phantom, 10 iterations, float32. The composed operator (the plan's
    normal at the "mats" level) and the Toeplitz one, with launch counts
    (the composed run: one planned spread and interp per iteration and
    one spread for the right-hand side; the Toeplitz run: that one spread
    only), each held to a complex128 CG-SENSE on the card (level "none",
    the float64 route; 2e-3 of the peak) and the Toeplitz one to the
    composed one (2e-3); Pipe-Menon weights on the trajectory (finite,
    sum 1, within 1e-4 of the peak of the same float32 weights computed
    on the CPU, and of the float64 ones within max(1e-4, 4 * floor_f32));
    times (CUDA events, median of 10) of the reconstructions and of the
    operators' builds."""
    import torch
    from tensorflow_nufft_tpu_torch.kernels import interp, spread
    from tensorflow_nufft_tpu_torch.models import mri
    pts = torch.from_numpy(mri.radial_trajectory(CG_SPOKES, CG_SAMPLES)).to(
        dev)
    maps = torch.from_numpy(mri.birdcage_maps(CG_COILS, CG_GRID)).to(dev)
    phantom = torch.from_numpy(mri.shepp_logan(CG_GRID)).to(dev)
    density = torch.from_numpy(mri.radial_density(CG_SPOKES,
                                                   CG_SAMPLES)).to(dev)

    def build(toeplitz=False):
        return mri.SenseNufft(pts, maps, CG_GRID, density=density, tol=TOL,
                              toeplitz=toeplitz)
    op, op_t = build(), build(toeplitz=True)
    if op._t2.level != "mats":
        raise RuntimeError(f"cg_sense: plan level {op._t2.level}, want "
                           f"mats")
    kspace = op.forward(phantom)
    torch.cuda.synchronize()
    reset_launches()
    rec = mri.cg_sense(kspace, op, num_iters=CG_ITERS)
    torch.cuda.synchronize()
    launches = read_launches("cg_sense")
    counts = step_launches()
    want = {spread.spread_planned_cuda.__name__: CG_ITERS + 1,
            interp.interp_planned_cuda.__name__: CG_ITERS}
    log(f"cg_sense composed launches: {counts}")
    if {k: n for k, n in counts.items() if n} != want:
        raise RuntimeError(f"cg_sense composed: launches {counts}, want "
                           f"{want}")
    reset_launches()
    rec_t = mri.cg_sense(kspace, op_t, num_iters=CG_ITERS)
    torch.cuda.synchronize()
    counts = step_launches()
    log(f"cg_sense Toeplitz launches: {counts}")
    if {k: n for k, n in counts.items() if n} != {
            spread.spread_planned_cuda.__name__: 1}:
        raise RuntimeError(f"cg_sense Toeplitz iterations launched "
                           f"{counts}")
    reset_launches()
    op64 = mri.SenseNufft(pts.double(), maps.double(), CG_GRID,
                          density=density.double(), tol=TOL)
    rec64 = mri.cg_sense(kspace.double(), op64, num_iters=CG_ITERS)
    torch.cuda.synchronize()
    no_launches("cg_sense complex128 reference")
    if op64._t2.level != "none":
        raise RuntimeError("cg_sense complex128 plan is not at level none")
    err = rel(rec, rec64)
    err_t = rel(rec_t, rec)
    err_ph = float(torch.linalg.norm(rec - phantom)
                   / torch.linalg.norm(phantom))
    log(f"cg_sense composed vs complex128: {err:.3e} of the peak (gate < "
        f"{CG_RTOL:g}); Toeplitz vs composed: {err_t:.3e} (gate < "
        f"{CG_RTOL:g}); composed vs phantom (relative norm): {err_ph:.3e}")
    # Pipe-Menon: the card's float32 weights against the same float32
    # algorithm on the CPU (only the atomics' order differs) and against
    # the float64 weights, at 4x the float32 algorithm's own distance from
    # them (its floor: 30 fixed-point steps amplify float32 rounding).
    w = mri.pipe_menon_density(pts, CG_GRID)
    w64 = mri.pipe_menon_density(pts.double(), CG_GRID)
    w_cpu = mri.pipe_menon_density(pts.cpu(), CG_GRID)
    floor = rel(w_cpu, w64.cpu())
    err_cpu, err_w = rel(w.cpu(), w_cpu), rel(w, w64)
    gate_w = max(1e-4, 4 * floor)
    total = float(w.double().sum())
    log(f"cg_sense pipe_menon_density: sum {total:.7f}; vs the float32 "
        f"weights on the CPU {err_cpu:.3e} of the peak (gate < 1e-4); vs "
        f"float64 {err_w:.3e} (gate < {gate_w:.3e}; floor_f32 {floor:.3e})")
    if not (bool(torch.isfinite(rec).all()) and err < CG_RTOL
            and err_t < CG_RTOL and bool(torch.isfinite(w).all())
            and abs(total - 1.0) < 1e-5 and err_cpu < 1e-4
            and err_w < gate_w):
        raise RuntimeError("cg_sense gates failed")
    cases = {
        "cg_sense_10iter_128_8coil_radial": lambda: mri.cg_sense(
            kspace, op, num_iters=CG_ITERS),
        "cg_sense_10iter_128_8coil_radial_toeplitz": lambda: mri.cg_sense(
            kspace, op_t, num_iters=CG_ITERS),
        "plan_build": build,
        "plan_build_toeplitz": lambda: build(toeplitz=True),
    }
    for name, fn in cases.items():
        log(f"time {name}: {cuda_ms(fn, reps=10, warmup=2):.4f} ms per "
            f"{'reconstruction' if name.startswith('cg') else 'build'}")
    return launches, cases


# bench_suite.py's 2d_t2_256_200k_b16_perbatch cell (nufft_case,
# bench_suite.py:206-260, registered at :696-697): 16 trajectories of
# 200,000 points, one per 256^2 image.
PB_GRID = (256, 256)
PB_BATCH = 16
PB_POINTS = 200_000


def perbatch_phase(dev):
    """bench_suite.py's 2d_t2_256_200k_b16_perbatch through
    planar.BatchedPlannedNufft: default_rng(7) points [16, 200000, 2] and
    images [16, 256, 256] (complex64, planar), tol 1e-6, type-2 forward.
    Each shard's level ("binned" at MATS_BYTES_BUDGET // 16) and geometry
    printed with the build time; one type-2 apply and one apply of the
    adjoint batch (type-1 backward, seeded values) counted as the main
    path: 16 unbanded interps and 16 unbanded spreads. Gates: both
    outputs equal the loop of PlannedNufft(points[i], budget // 16) bit
    for bit; on trajectories 0 and 15 err_total < 10 * tol against the
    exact NUDFT (complex128 on the card, 4096 seeded points or modes) and
    err_impl < tol against the float64 route; a backward through the op
    gives the adjoint batch's output; an inner batch axis [16, 2, ...]
    equals two applies. The rank-2 binned kernels held to their plain
    versions at shard 0's geometry; times (CUDA events, median of 25)."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    rng = np.random.default_rng(7)
    points = rng.uniform(-np.pi, np.pi, (PB_BATCH, PB_POINTS, 2)).astype(
        np.float32)
    shape = (PB_BATCH,) + PB_GRID
    z = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    sub = np.random.default_rng(SEED + 14)
    c = (sub.standard_normal((PB_BATCH, PB_POINTS))
         + 1j * sub.standard_normal((PB_BATCH, PB_POINTS))).astype(
             np.complex64)
    pts = torch.from_numpy(points).to(dev)
    x = torch.view_as_real(torch.from_numpy(z)).to(dev)
    cp = torch.view_as_real(torch.from_numpy(c)).to(dev)

    def build():
        return planar.BatchedPlannedNufft(pts, PB_GRID, tol=TOL)
    torch.cuda.synchronize()
    start = time.perf_counter()
    op = build()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - start) * 1e3
    adj = op.adjoint()
    for i, sh in enumerate(op._shards):
        g = sh.geom
        log(f"perbatch shard {i}: level {sh.level}, fine {g.fine_shape} "
            f"tiles {g.tiles} ext {g.ext} chunk {g.chunk} chunks "
            f"{g.num_chunks} (used {int(sh.binned.tile_bounds[-1])}), "
            f"slots {g.num_slots}")
    if any(sh.level != "binned" for sh in op._shards):
        raise RuntimeError("perbatch: a shard is not at the binned level")
    reset_launches()
    with no_plain_calls("perbatch"):
        y = op(x)
        xt = adj(cp)
        torch.cuda.synchronize()
    launches = read_launches("perbatch")
    counts = {k: n for k, n in step_launches().items() if n}
    want = {interp.interp_unplanned_cuda.__name__: PB_BATCH,
            spread.spread_unplanned_cuda.__name__: PB_BATCH}
    log(f"perbatch launches (one apply of each type): {counts}")
    if counts != want:
        raise RuntimeError(f"perbatch launches {counts}, want {want}")

    budget = binning.MATS_BYTES_BUDGET // PB_BATCH
    for i in range(PB_BATCH):
        one = planar.PlannedNufft(pts[i], PB_GRID, tol=TOL,
                                  payload_budget_bytes=budget)
        if not (torch.equal(y[i], one(x[i][None])[0])
                and torch.equal(xt[i], one.adjoint()(cp[i][None])[0])):
            raise RuntimeError(f"perbatch trajectory {i} differs from its "
                               f"single plan")
    log(f"perbatch: both applies equal the loop of {PB_BATCH} single "
        f"plans (budget {budget} B) bit for bit")

    idx_pts = torch.from_numpy(np.sort(sub.choice(
        PB_POINTS, SUBSET, replace=False))).to(dev)
    idx_modes = torch.from_numpy(np.sort(sub.choice(
        int(np.prod(PB_GRID)), SUBSET, replace=False))).to(dev)
    failed = []
    for i in (0, PB_BATCH - 1):
        x64 = pts[i].double()
        f64 = torch.from_numpy(z[i]).to(dev).to(torch.complex128)
        c64 = torch.from_numpy(c[i]).to(dev).to(torch.complex128)
        ref2 = torch.view_as_complex(planar.nufft(
            x[i][None].double(), x64, tol=TOL)[0].contiguous())
        ref1 = torch.view_as_complex(planar.nufft(
            cp[i][None].double(), x64, grid_shape=PB_GRID,
            transform_type="type_1", fft_direction="backward",
            tol=TOL)[0].contiguous())
        got2 = torch.view_as_complex(y[i].contiguous())
        got1 = torch.view_as_complex(xt[i].contiguous())
        exact2 = exact_type2_subset(x64, f64, idx_pts, -1.0, dev,
                                    grid=PB_GRID)
        exact1 = exact_type1_subset(x64, c64, idx_modes, dev, sign=1.0,
                                    grid=PB_GRID)
        for label, got, ref, exact, idx in (
                ("type-2", got2, ref2, exact2, idx_pts),
                ("type-1 (adjoint)", got1, ref1, exact1, idx_modes)):
            err_total = rel(got.reshape(-1)[idx], exact)
            err_impl = rel(got, ref)
            log(f"perbatch trajectory {i} {label}: err_total ({SUBSET}-"
                f"element subset, exact NUDFT) {err_total:.3e} (gate < "
                f"{10 * TOL:g}), err_impl (float64 route) {err_impl:.3e} "
                f"(gate < {TOL:g})")
            if not (err_total < 10 * TOL and err_impl < TOL):
                failed.append((i, label))
    xg = x.clone().requires_grad_()
    op(xg).backward(cp)
    if not torch.equal(xg.grad, xt):
        failed.append("backward is not the adjoint batch")
    log("perbatch: x.grad of a backward equals the adjoint batch's "
        f"output bit for bit: {torch.equal(xg.grad, xt)}")
    del xg
    y2 = op(torch.stack([x, 0.5 * x], dim=1))
    for j, want_j in ((0, y), (1, op(0.5 * x))):
        same = torch.equal(y2[:, j], want_j)
        err = 0.0 if same else rel(y2[:, j], want_j)
        log(f"perbatch inner batch axis, element {j}: equals a single "
            f"apply bit for bit: {same} ({err:.3e} of the peak, gate < "
            f"1e-6)")
        if not err < 1e-6:
            failed.append(f"inner axis element {j}")
    del y2
    if failed:
        raise RuntimeError(f"perbatch gates failed: {failed}")

    # The rank-2 binned kernels at shard 0's geometry (coords, the
    # unbanded kernels), held to their plain versions and timed.
    sh = op._shards[0]
    geom, plan, tb = sh.geom, sh.plan, sh.binned.tile_bounds
    used = int(tb[-1]) * geom.chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    values_pl = binning.build_values_payload(cp[0].t().contiguous(),
                                             sh.binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    wrap = wrappers()
    results = {}
    for name, kernel, plain, kind in (
            ("spread2d_binned_perbatch",
             functools.partial(wrap["spread2d_binned_perbatch"], values_pl,
                               tb, geom, plan, sh.coords),
             functools.partial(spread.spread_tiles_plain, values_pl, tb,
                               geom, plan, coords=sh.coords), "spread"),
            ("interp2d_binned_perbatch",
             functools.partial(wrap["interp2d_binned_perbatch"], tiles, tb,
                               geom, plan, sh.coords),
             functools.partial(interp.interp_tiles_plain, tiles, tb, geom,
                               plan, coords=sh.coords), "interp")):
        hold(name, kernel, plain, results)
        time_pair(name, kernel, plain, results,
                  tile_work(kind, False, geom, plan, 2, PB_POINTS, used))
    cases = {"perbatch_type2": lambda: op(x),
             "perbatch_type1_adjoint": lambda: adj(cp),
             "perbatch_build": build}
    total = PB_BATCH * PB_POINTS
    for name, fn in cases.items():
        ms = cuda_ms(fn, reps=3 if name.endswith("build") else REPS,
                     warmup=1 if name.endswith("build") else WARMUP)
        rate = ("" if name.endswith("build")
                else f", {total / ms * 1e3:.4e} points/s")
        log(f"time 2d_t2_256_200k_b16_perbatch {name}: {ms:.4f} ms{rate}")
    log(f"time 2d_t2_256_200k_b16_perbatch first build: {build_ms:.4f} ms")
    return launches, results, cases


# bench_suite.py's type-3 cells (type3_case, bench_suite.py:342-404,
# registered at :747-757): (name, rank, M = K, t_range, planned).
T3_CELLS = (("2d_t3_200k_200k", 2, 200_000, 64.0, True),
            ("3d_t3_500k_500k", 3, 500_000, 16.0, True),
            ("3d_t3_500k_500k_unplanned", 3, 500_000, 16.0, False))
# The stage levels the KERNELS rows of the type-3 phases assume (the
# port's Type3Plan rule at these inputs): (outer spread, inner type-2,
# whether the inner one is banded).
T3_LEVELS = {2: ("binned", "mats", False), 3: ("mats", "binned", True)}


def type3_inputs(rank, m, t_range):
    """bench_suite.py's type-3 inputs (default_rng(7)): points in [-pi,
    pi), targets in [-t_range, t_range), both [M, rank] float32, and
    complex normal strengths [M] (complex64)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32)
    t = rng.uniform(-t_range, t_range, (m, rank)).astype(np.float32)
    z = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64)
    return x, t, z


def plain_type3(op, source):
    """A planar Type3Plan's pipeline on the port's plain versions, called
    directly (no dispatch): the prephase, the plain spread onto the fine
    grid from the plan's windows or coords, the plain fold, the plain
    type-2 pipeline of the inner plan (``plain_pipeline``), the
    postphase. source [B, M, 2] on the card, float32."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import binning, mode3d, spread
    batch = source.shape[0]
    src = planar.pmul(source, op._prephase)
    values = binning.build_values_payload(
        src.movedim(-1, 1).reshape(2 * batch, -1), op.binned)
    tiles = spread.spread_tiles_plain(values, op.binned.tile_bounds, op.geom,
                                      op._spread_plan, kw=op.weights,
                                      coords=op.coords)
    fine = torch.view_as_real(mode3d.fold_plain(tiles, op.geom, batch))
    inner = op._inner_t2
    vals = plain_pipeline(fine.contiguous(), inner.points, inner.plan)
    return planar.pmul(vals, op._postphase)


def exact_type3_subset(x, t, c, idx, sign=-1.0):
    """The type-3 NUDFT sum_j c_j exp(sign i t_k . x_j) in complex128 at
    the targets ``idx``, summed over all points in chunks."""
    import torch
    tt = t[idx].double()
    x64 = x.double()
    out = torch.zeros(len(idx), dtype=torch.complex128, device=x.device)
    for lo in range(0, x64.shape[0], 8192):
        phase = sign * (tt @ x64[lo:lo + 8192].T)          # [S, chunk]
        out += torch.polar(torch.ones_like(phase), phase) @ c[lo:lo + 8192]
    return out


def describe_type3(name, op):
    """Logs a planar Type3Plan's statics, both stages' levels and
    geometries, the inner band and chunk use."""
    inner = op._inner_t2
    g, gi = op.geom, inner.geom
    log(f"{name}: fine_shape {op.fine_shape}, width "
        f"{op._spread_plan.width}; outer spread level {op._spread_level}, "
        f"tiles {g.tiles} ext {g.ext} chunk {g.chunk} chunks "
        f"{g.num_chunks} (used {int(op.binned.tile_bounds[-1])}); inner "
        f"type-2 level {inner.level}, fine {inner.plan.fine_shape} tiles "
        f"{gi.tiles} ext {gi.ext} chunk {gi.chunk} chunks {gi.num_chunks} "
        f"(used {int(inner.binned.tile_bounds[-1])}), band "
        f"{inner.band_info.band if inner.band_info else None}")


def type3_phase(dev):
    """bench_suite.py's three type-3 cells through planar.Type3Plan (the
    unplanned cell through planar.nufft_type3, which builds its plan in
    every call): each apply counted as a main path (the outer spread
    once, at rank 3 fold3d once, the inner interp once and at rank 3
    modes_to_fine 3 and extend_tiles3d once), with no plain version on
    the card path. Gates: (a) against the float32 plain pipeline of the
    same plan on the card (``plain_type3``) < 10 * tol of the peak,
    bench_suite.py's gate; (b) err_total against the exact type-3 NUDFT
    (complex128, 4096 seeded targets) < max(10 * tol, 4 * floor_f32);
    (c) err_impl against complex128 tnt.Type3Plan (the float64 route, no
    launch) < max(tol, 4 * floor_f32), floor_f32 the plain pipeline's
    error against the same reference; (d) complex64 tnt.Type3Plan within
    the same gates; (e) <A c, y> = <c, A^H y> within 1e-5 relative; (f) a
    backward through the plan equals op.adjoint() on the cotangent, bit
    for bit. Each stage's kernel held to its plain version at the cell's
    geometry and timed; each cell's apply timed (CUDA events, median of
    25, unplanned 5), points/s as (M + K) / time."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import (fft3d, interp, mode3d,
                                                    spread)
    launches, results, cases, refs = {}, {}, {}, {}
    plans = {}
    for name, rank, m, t_range, planned in T3_CELLS:
        if rank not in refs:
            x, t, z = type3_inputs(rank, m, t_range)
            xt, tt = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
            c64 = torch.from_numpy(z).to(dev)
            src = torch.view_as_real(c64)[None].contiguous()
            refs[rank] = dict(xt=xt, tt=tt, c64=c64, src=src)
        r = refs[rank]
        xt, tt, c64, src = r["xt"], r["tt"], r["c64"], r["src"]
        if planned:
            def build(xt=xt, tt=tt):
                return planar.Type3Plan(xt, tt, tol=TOL)
            torch.cuda.synchronize()
            start = time.perf_counter()
            op = plans[rank] = build()
            torch.cuda.synchronize()
            log(f"{name}: first plan build {(time.perf_counter() - start) * 1e3:.4f} ms")
            describe_type3(name, op)
            inner = op._inner_t2
            got = (op._spread_level, inner.level, inner.band_info is not None)
            if got != T3_LEVELS[rank]:
                raise RuntimeError(f"{name}: levels {got}, the KERNELS "
                                   f"rows assume {T3_LEVELS[rank]}")

            def apply(op=op, src=src):
                return op(src)
            phase = f"type3_{rank}d"
        else:
            op = plans[rank]

            def apply(xt=xt, tt=tt, src=src):
                return planar.nufft_type3(src, xt, tt, tol=TOL)
            phase = "type3_3d_unplanned"
        reset_launches()
        with no_plain_calls(name):
            out = apply()
            torch.cuda.synchronize()
        launches[phase] = read_launches(phase)
        counts = {k: n for k, n in step_launches().items() if n}
        inner = op._inner_t2
        want = {(spread.spread_planned_cuda if op._spread_level == "mats"
                 else spread.spread_unplanned_cuda).__name__: 1,
                (interp.interp_planned_cuda if inner.level == "mats"
                 else interp.interp_banded_cuda if inner.band_info
                 else interp.interp_unplanned_cuda).__name__: 1}
        if rank == 3:
            want.update({mode3d.fold3d_cuda.__name__: 1,
                         mode3d.extend_tiles3d_cuda.__name__: 1,
                         fft3d.modes_to_fine_cuda.__name__: 3})
        log(f"{name} launches (one apply): {counts}")
        if counts != want:
            raise RuntimeError(f"{name}: launches {counts}, want {want}")

        # Gates (a)-(d).
        if "ref64" not in r:
            r["plain"] = plain_type3(op, src)
            sub = np.random.default_rng(SEED + 15 + rank)
            r["idx"] = torch.from_numpy(np.sort(sub.choice(
                m, SUBSET, replace=False))).to(dev)
            c128 = c64.to(torch.complex128)
            r["exact"] = exact_type3_subset(xt, tt, c128, r["idx"])
            reset_launches()
            r["ref64"] = tnt.Type3Plan(xt.double(), tt.double(),
                                       tol=TOL)(c128[None])[0]
            torch.cuda.synchronize()
            no_launches(f"{name} complex128 reference")
            r["complex64"] = tnt.Type3Plan(xt, tt, tol=TOL)(c64[None])[0]
        plain, idx, exact, ref64 = r["plain"], r["idx"], r["exact"], r["ref64"]
        plain_c = torch.view_as_complex(plain[0].contiguous())
        floor_total, floor_impl = rel(plain_c[idx], exact), rel(plain_c, ref64)
        gate_total = max(10 * TOL, 4 * floor_total)
        gate_impl = max(TOL, 4 * floor_impl)
        err_plain = rel(out, plain)
        log(f"{name} (a): vs the float32 plain pipeline {err_plain:.3e} of "
            f"the peak (gate < {10 * TOL:g}); floor_f32: {floor_total:.3e} "
            f"vs exact, {floor_impl:.3e} vs complex128")
        ok = err_plain < 10 * TOL
        for label, got in (("planar", torch.view_as_complex(
                out[0].contiguous())), ("complex64 tnt.Type3Plan",
                                        r["complex64"])):
            err_total, err_impl = rel(got[idx], exact), rel(got, ref64)
            log(f"{name} {label}: (b) err_total ({SUBSET} targets, exact "
                f"NUDFT) {err_total:.3e} (gate < {gate_total:.3e}; below "
                f"10 * tol: {err_total < 10 * TOL}); (c) err_impl (vs "
                f"complex128 Type3Plan) {err_impl:.3e} (gate < "
                f"{gate_impl:.3e}; below tol: {err_impl < TOL})")
            ok = ok and err_total < gate_total and err_impl < gate_impl
        if not planned:
            same = torch.equal(out, plans[rank](src))
            log(f"{name}: equals the planned cell's output bit for bit: "
                f"{same}")
        else:
            # (e) and (f).
            gen = torch.Generator(device=dev).manual_seed(SEED + 17 + rank)
            yv = torch.randn((1, m, 2), generator=gen, device=dev)
            adj = op.adjoint()

            def inner_product(a, b):
                a, b = a.double(), b.double()
                return complex(float((a[..., 0] * b[..., 0]
                                      + a[..., 1] * b[..., 1]).sum()),
                               float((a[..., 1] * b[..., 0]
                                      - a[..., 0] * b[..., 1]).sum()))
            back = adj(yv)
            lhs, rhs = inner_product(out, yv), inner_product(src, back)
            err_adj = abs(lhs - rhs) / abs(lhs)
            s = src.clone().requires_grad_()
            op(s).backward(yv)
            same = torch.equal(s.grad, back)
            log(f"{name}: (e) <A c, y> = {lhs:.6e}, <c, A^H y> = {rhs:.6e}, "
                f"relative difference {err_adj:.3e} (gate < 1e-5); (f) the "
                f"backward equals op.adjoint() bit for bit: {same}")
            ok = ok and err_adj < 1e-5 and same
            del s, back, yv
        if not ok:
            raise RuntimeError(f"{name} gates failed")

        if planned:
            results.update(type3_kernels(name, rank, op, src, dev))
            cases[f"{name}_build"] = build
        cases[name] = apply
        reps = REPS if planned else 5
        ms = cuda_ms(apply, reps=reps, warmup=WARMUP if planned else 1)
        log(f"time {name}: {ms:.4f} ms per transform, "
            f"{2 * m / ms * 1e3:.4e} points/s ((M + K) / time; median of "
            f"{reps})")
        if planned:
            log(f"time {name} plan build: "
                f"{cuda_ms(build, reps=3, warmup=1):.4f} ms (median of 3)")
        torch.cuda.empty_cache()
    return launches, results, cases


def type3_kernels(name, rank, op, src, dev):
    """Each stage kernel of a planar Type3Plan held to its plain version
    at the plan's geometries and timed: the outer spread (from the
    prephased strengths) and the inner interp; at rank 3 also fold3d at
    the outer geometry and extend_tiles3d and modes_to_fine at the inner
    one (``halo_phase``, ``stage_phase``)."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
    inner = op._inner_t2
    m, k = op.num_points, op.num_targets
    gen = torch.Generator(device=dev).manual_seed(SEED + 18 + rank)
    cm = planar.pmul(src, op._prephase)[0].t().contiguous()
    values_pl = binning.build_values_payload(cm, op.binned)
    g, tb = op.geom, op.binned.tile_bounds
    gi, tbi = inner.geom, inner.binned.tile_bounds
    tiles_i = torch.randn(gi.tiles + (2,) + gi.ext, generator=gen,
                          device=dev)
    wrap = wrappers()
    sname, iname = f"spread_t3_{rank}d", f"interp_t3_{rank}d"
    if op.weights is not None:
        spread_args, spread_kw = (op.weights,), dict(kw=op.weights)
    else:
        spread_args, spread_kw = (op.coords,), dict(coords=op.coords)
    if inner.weights is not None:
        interp_args, interp_kw = (inner.weights,), dict(kw=inner.weights)
    elif inner.band_info is not None:
        interp_args = (inner.coords, inner.band_info)
        interp_kw = dict(coords=inner.coords, band=inner.band_info)
    else:
        interp_args, interp_kw = (inner.coords,), dict(coords=inner.coords)
    results = {}
    for kname, kernel, plain, work in (
            (sname, functools.partial(wrap[sname], values_pl, tb, g,
                                      op._spread_plan, *spread_args),
             functools.partial(spread.spread_tiles_plain, values_pl, tb, g,
                               op._spread_plan, **spread_kw),
             tile_work("spread", op.weights is not None, g, op._spread_plan,
                       2, m, int(tb[-1]) * g.chunk)),
            (iname, functools.partial(wrap[iname], tiles_i, tbi, gi,
                                      inner.plan, *interp_args),
             functools.partial(interp.interp_tiles_plain, tiles_i, tbi, gi,
                               inner.plan, **interp_kw),
             tile_work("interp", inner.weights is not None, gi, inner.plan,
                       2, k, int(tbi[-1]) * gi.chunk))):
        hold(kname, kernel, plain, results)
        time_pair(kname, kernel, plain, results, work,
                  label=f"{kname} {name}")
    if rank == 3:
        def cplx(shape):
            return torch.complex(*(torch.randn(shape, generator=gen,
                                               device=dev)
                                   for _ in range(2)))
        outer, inner_halo, stages = {}, {}, {}
        tiles_o = wrap[sname](values_pl, tb, g, op._spread_plan,
                              *spread_args)
        halo_phase(f"{name} outer", g, 1, tiles_o,
                   cplx((1,) + g.fine_shape), outer)
        halo_phase(f"{name} inner", gi, 1, tiles_i,
                   cplx((1,) + gi.fine_shape), inner_halo)
        stage_phase(f"{name} inner", inner.plan, 1, stages, gen,
                    kinds=("modes_to_fine",))
        results["fold3d_t3"] = outer["fold3d"]
        results["extend_tiles3d_t3"] = inner_halo["extend_tiles3d"]
        results["modes_to_fine_t3"] = stages["modes_to_fine"]
    return results


# The sharded phase: the calls of the JAX package's multichip dry run
# (__graft_entry__._dryrun_impl, __graft_entry__.py:99-209) at the width
# of bench_suite.py's CG-SENSE cell (the CG_* inputs), on a ("data",
# "points") mesh of shape (2, 4) repeating this card; then the 3D
# headline planned on 2 points shards and bench_suite.py's
# 2d_t3_200k_200k sharded over 4.
SH_MESH = (2, 4)
SH_REPS = 10


def sharded_call(label, fn, want):
    """Runs ``fn`` once with every launch count at 0 and no plain
    version allowed on the card path; fails unless the wrappers' counts
    are ``want`` (wrapper -> launches) or torch.fft ran on a rank-3 grid
    on the card. Returns its output."""
    import torch
    reset_launches()
    with no_plain_calls(label):
        out = fn()
        torch.cuda.synchronize()
    counts = {k: n for k, n in step_launches().items() if n}
    want = {w.__name__: n for w, n in want.items()}
    log(f"sharded {label} launches: {counts}; rank-3 torch.fft calls on "
        f"the card: {_CARD_FFT_PLAIN[0]}")
    if counts != want or _CARD_FFT_PLAIN[0]:
        raise RuntimeError(f"sharded {label}: launches {counts}, want "
                           f"{want}")
    return out


def sharded_phase(dev, smi):
    """The JAX multichip dry run's calls through tnt.parallel at the
    CG-SENSE cell's width (128^2, 8 birdcage coils, 128 radial spokes of
    256 samples, Shepp-Logan; tol 1e-6) on a (2, 4) ("data", "points")
    mesh of this card: sharded_nufft type-2 of the coil images and the
    gradient of its loss in the image, type-1 of the k-space,
    sharded_nufft_grid type-1 and type-2 over "points" (the data axis
    replicated, computed once), ShardedPlannedNufft type-2 ("mats"
    shards), normal with slot_weights(ones), the gradient of the planned
    loss through the apply and normal, the slot surface (a slot-order
    data-consistency loss and its gradient; from_slots(to_slots(y)) == y
    bit for bit); sharded_nufft_type3 at 2d_t3_200k_200k (batch 2); the
    3D headline (128^3, 800,000 points) through ShardedPlannedNufft
    type-1 and its adjoint on 2 points shards of 400,000 ("binned" with
    the uniform band). Each call counted alone: the wrappers' launches
    must be the blocks' (a zero fails). Gates: each output and gradient
    within 1e-5 of the peak of the port's unsharded counterpart
    (planar.nufft, PlannedNufft, planar.Type3Plan) on the same global
    inputs, and err_total < 10 * tol against exact complex128 NUDFTs
    (2D: 4096 seeded points or all modes; 3D: 4096 seeded elements;
    type-3: phase 5e's gate on 4096 targets). Times: CUDA-event medians
    of 10 of each sharded call beside its unsharded call (the type-3,
    a one-shot transform, beside the planned and the one-shot
    unsharded calls); on one card the blocks run in turn, so these are
    the single-controller dispatch's cost, not scaling. Returns the
    timed calls (label -> callable) for --profile."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import (fft3d, interp, mode3d,
                                                    spread)
    from tensorflow_nufft_tpu_torch.models import mri
    from tensorflow_nufft_tpu_torch.parallel import (
        Mesh, ShardedPlannedNufft, sharded_nufft, sharded_nufft_grid,
        sharded_nufft_type3)
    mesh = Mesh(np.array([str(dev)] * int(np.prod(SH_MESH))).reshape(
        SH_MESH), ("data", "points"))
    blocks, slabs = int(np.prod(SH_MESH)), SH_MESH[1]
    n = CG_GRID[0]
    x = torch.from_numpy(mri.radial_trajectory(CG_SPOKES, CG_SAMPLES)).to(
        dev)
    m = x.shape[0]
    maps = torch.from_numpy(mri.birdcage_maps(CG_COILS, CG_GRID)).to(dev)
    image = torch.from_numpy(mri.shepp_logan(CG_GRID)).to(dev)
    log(f"sharded: mesh {mesh.shape} of {dev}, {m} points, grid {CG_GRID}, "
        f"{CG_COILS} coils; {smi}")

    # Exact complex128 operators of the cell: A (type-2 forward) and A^H.
    x64 = x.double()
    sub = np.random.default_rng(SEED + 20)
    idx = torch.from_numpy(np.sort(sub.choice(m, SUBSET, replace=False))).to(
        dev)

    def cplx(p):
        return torch.view_as_complex(p.double().contiguous())

    def exact_a(s, points=x64):
        return exact2d_type2(cplx(s), points, -1.0, n=n)

    def exact_ah(y):
        return exact2d_type1(y, x64, 1.0, n=n)

    def image_grad(g):
        """d/d image of a loss whose coil-image gradient is g (complex)."""
        return torch.view_as_real((cplx(maps).conj() * g).sum(0))

    failed = []

    def gate(label, got, unsharded, exact=None, exact_idx=None):
        err_u = rel(got, unsharded)
        line = (f"sharded {label}: vs unsharded {err_u:.3e} of the peak "
                f"(gate < {KERNEL_RTOL:g})")
        ok = bool(torch.isfinite(got).all()) and err_u < KERNEL_RTOL
        if exact is not None:
            g = cplx(got) if not got.is_complex() else got
            if exact_idx is not None:
                g = g[:, exact_idx]
            err_t = rel(g, exact)
            line += f"; err_total (exact NUDFT) {err_t:.3e} (gate < " \
                    f"{10 * TOL:g})"
            ok = ok and err_t < 10 * TOL
        log(line)
        if not ok:
            failed.append(label)

    cases = {}

    def timed(label, sharded_fn, unsharded_fn, unsharded="unsharded"):
        cases[f"sharded {label}"] = sharded_fn
        cases[f"{unsharded} {label}"] = unsharded_fn
        log(f"time sharded {label}: "
            f"{cuda_ms(sharded_fn, reps=SH_REPS, warmup=2):.4f} ms, "
            f"{unsharded} {cuda_ms(unsharded_fn, reps=SH_REPS, warmup=2):.4f}"
            f" ms (CUDA-event medians of {SH_REPS}; {smi})")

    coil_images = mri.pmul(maps, image[None])           # [C, n, n, 2]
    ksp_exact = exact_a(coil_images)                    # [C, M]

    # 1. sharded_nufft type-2 and the gradient of its loss in the image.
    ksp = sharded_call("nufft type-2", lambda: sharded_nufft(
        coil_images, x, mesh, tol=TOL), {
            interp.interp_unplanned_cuda: blocks})
    ksp_u = planar.nufft(coil_images, x, tol=TOL)
    gate("nufft type-2", ksp, ksp_u, ksp_exact[:, idx], idx)

    def loss_grad(fn):
        img = image.clone().requires_grad_()
        pred = fn(mri.pmul(maps, img[None]))
        (pred * pred).sum().backward()
        return img.grad
    grad = sharded_call("nufft type-2 loss gradient", lambda: loss_grad(
        lambda ci: sharded_nufft(ci, x, mesh, tol=TOL)), {
            interp.interp_unplanned_cuda: blocks,
            spread.spread_unplanned_cuda: blocks})
    grad_u = loss_grad(lambda ci: planar.nufft(ci, x, tol=TOL))
    grad_exact = image_grad(2 * exact_ah(ksp_exact))
    gate("nufft type-2 loss gradient", grad, grad_u)
    err = rel(grad, grad_exact)
    log(f"sharded nufft type-2 loss gradient: err_total (exact NUDFTs) "
        f"{err:.3e} (gate < {10 * TOL:g})")
    if not err < 10 * TOL:
        failed.append("nufft type-2 loss gradient (exact)")
    timed("nufft type-2", lambda: sharded_nufft(coil_images, x, mesh,
                                                tol=TOL),
          lambda: planar.nufft(coil_images, x, tol=TOL))

    # 2. Type-1 of the measured k-space, sharded over data and points,
    # and over the mode grid's leading axis (the points axis of the mesh).
    modes_exact = exact_ah(cplx(ksp_u))                  # [C, n, n]
    kw1 = dict(grid_shape=CG_GRID, transform_type="type_1",
               fft_direction="backward", tol=TOL)
    t1 = sharded_call("nufft type-1", lambda: sharded_nufft(
        ksp_u, x, mesh, **kw1), {spread.spread_unplanned_cuda: blocks})
    t1_u = planar.nufft(ksp_u, x, **kw1)
    gate("nufft type-1", t1, t1_u, modes_exact)
    timed("nufft type-1", lambda: sharded_nufft(ksp_u, x, mesh, **kw1),
          lambda: planar.nufft(ksp_u, x, **kw1))
    g1 = sharded_call("nufft_grid type-1", lambda: sharded_nufft_grid(
        ksp_u, x, mesh, grid_axis="points", **kw1),
        {spread.spread_unplanned_cuda: slabs})
    gate("nufft_grid type-1", g1, t1_u, modes_exact)
    g2 = sharded_call("nufft_grid type-2", lambda: sharded_nufft_grid(
        coil_images, x, mesh, grid_axis="points", tol=TOL),
        {interp.interp_unplanned_cuda: slabs})
    gate("nufft_grid type-2", g2, ksp_u, ksp_exact[:, idx], idx)
    timed("nufft_grid type-1", lambda: sharded_nufft_grid(
        ksp_u, x, mesh, grid_axis="points", **kw1),
        lambda: planar.nufft(ksp_u, x, **kw1))
    timed("nufft_grid type-2", lambda: sharded_nufft_grid(
        coil_images, x, mesh, grid_axis="points", tol=TOL),
        lambda: planar.nufft(coil_images, x, tol=TOL))

    # 3. ShardedPlannedNufft: apply, normal, the planned loss gradient.
    op = ShardedPlannedNufft(x, CG_GRID, mesh, tol=TOL)
    ref = planar.PlannedNufft(x, CG_GRID, tol=TOL)
    log(f"sharded planned 2D: level {op.level}, shard levels "
        f"{[sh.level for sh in op._shards]}, slots {op.num_slots}; "
        f"unsharded level {ref.level}")
    if op.level != "mats" or ref.level != "mats":
        raise RuntimeError("sharded planned 2D: not at the mats level")
    kp = sharded_call("planned type-2", lambda: op(coil_images), {
        interp.interp_planned_cuda: blocks})
    kp_u = ref(coil_images)
    gate("planned type-2", kp, kp_u, ksp_exact[:, idx], idx)
    sw = op.slot_weights(torch.ones(m, device=dev))
    nrm = sharded_call("planned normal", lambda: op.normal(
        coil_images, sw), {interp.interp_planned_cuda: blocks,
                           spread.spread_planned_cuda: blocks})
    normal_exact = exact_ah(ksp_exact)
    gate("planned normal", nrm, ref.normal(
        coil_images, ref.slot_weights(torch.ones(m, device=dev))),
        normal_exact)

    def planned_grad(fwd, normal):
        img = image.clone().requires_grad_()
        ci = mri.pmul(maps, img[None])
        pred, out = fwd(ci), normal(ci)
        ((pred * pred).sum() + (out * out).sum()).backward()
        return img.grad
    pg = sharded_call("planned loss gradient", lambda: planned_grad(
        op, lambda ci: op.normal(ci, sw)), {
            interp.interp_planned_cuda: 3 * blocks,
            spread.spread_planned_cuda: 3 * blocks})
    sw_u = ref.slot_weights(torch.ones(m, device=dev))
    pg_u = planned_grad(ref, lambda ci: ref.normal(ci, sw_u))
    gate("planned loss gradient", pg, pg_u)
    pg_exact = image_grad(2 * normal_exact + 2 * exact_ah(exact_a(
        torch.view_as_real(normal_exact))))
    err = rel(pg, pg_exact)
    log(f"sharded planned loss gradient: err_total (exact NUDFTs) "
        f"{err:.3e} (gate < {10 * TOL:g})")
    if not err < 10 * TOL:
        failed.append("planned loss gradient (exact)")
    timed("planned type-2", lambda: op(coil_images),
          lambda: ref(coil_images))
    timed("planned normal", lambda: op.normal(coil_images, sw),
          lambda: ref.normal(coil_images, sw_u))

    # 4. The slot surface: to_slots/from_slots are gathers (no kernel);
    # the dry run's slot-order data-consistency loss and its gradient.
    t1_op = op.adjoint()
    y_slots = op.to_slots(0.5 * kp)
    same = torch.equal(op.from_slots(y_slots), 0.5 * kp)
    log(f"sharded from_slots(to_slots(y)) equals y bit for bit: {same}")
    if not same:
        failed.append("slot round trip")

    def slots_grad(t2, t1o, ys):
        img = image.clone().requires_grad_()
        r = t2.apply_to_slots(mri.pmul(maps, img[None])) - ys
        back = t1o.apply_from_slots(r)
        (back * back).sum().backward()
        return back.detach(), img.grad
    back, sg = sharded_call("slot loss gradient", lambda: slots_grad(
        op, t1_op, y_slots), {interp.interp_planned_cuda: 2 * blocks,
                              spread.spread_planned_cuda: 2 * blocks})
    back_u, sg_u = slots_grad(ref, ref.adjoint(), ref.to_slots(0.5 * kp_u))
    back_exact = exact_ah(0.5 * ksp_exact)
    gate("slot apply_to/from_slots", back, back_u, back_exact)
    gate("slot loss gradient", sg, sg_u)
    del back, back_u, sg, sg_u, grad, grad_u, pg, pg_u

    # 5. sharded_nufft_type3 at 2d_t3_200k_200k (default_rng(7)), batch 2.
    name, rank, m3, t_range, _ = T3_CELLS[0]
    xs, ts, z = type3_inputs(rank, m3, t_range)
    xt, tt = torch.from_numpy(xs).to(dev), torch.from_numpy(ts).to(dev)
    c2 = np.random.default_rng(SEED + 21).standard_normal((m3, 2)).astype(
        np.float32)
    src3 = torch.stack([torch.view_as_real(torch.from_numpy(z)),
                        torch.from_numpy(c2)]).to(dev)          # [2, M, 2]
    t3 = sharded_call(f"type3 {name}", lambda: sharded_nufft_type3(
        src3, xt, tt, mesh, tol=TOL), {
            spread.spread_unplanned_cuda: blocks,
            interp.interp_unplanned_cuda: blocks})
    op3 = planar.Type3Plan(xt, tt, tol=TOL)
    t3_u = op3(src3)
    gate(f"type3 {name}", t3, t3_u)
    sub3 = np.random.default_rng(SEED + 15 + rank)
    idx3 = torch.from_numpy(np.sort(sub3.choice(m3, SUBSET,
                                                replace=False))).to(dev)
    exact3 = exact_type3_subset(xt, tt, torch.from_numpy(z).to(dev).to(
        torch.complex128), idx3)
    plain = torch.view_as_complex(plain_type3(op3, src3[:1])[0].contiguous())
    floor_total = rel(plain[idx3], exact3)
    gate_total = max(10 * TOL, 4 * floor_total)
    err = rel(torch.view_as_complex(t3[0].contiguous())[idx3], exact3)
    log(f"sharded type3 {name}: err_total ({SUBSET} targets, exact "
        f"NUDFT) {err:.3e} (gate < {gate_total:.3e}; floor_f32 "
        f"{floor_total:.3e}; below 10 * tol: {err < 10 * TOL})")
    if not err < gate_total:
        failed.append(f"type3 {name} (exact)")
    # The sharded type-3 is a one-shot transform: it computes the
    # statics and bins its blocks in every call, as planar.nufft_type3
    # does; the planned Type3Plan apply beside it.
    timed(f"type3 {name}", lambda: sharded_nufft_type3(
        src3, xt, tt, mesh, tol=TOL), lambda: op3(src3), "planned")
    timed(f"type3 {name} one-shot", lambda: sharded_nufft_type3(
        src3, xt, tt, mesh, tol=TOL), lambda: planar.nufft_type3(
            src3, xt, tt, tol=TOL))
    del t3, t3_u, plain
    torch.cuda.empty_cache()

    # 6. Rank 3: the 3D headline planned on 2 points shards.
    points3, z3, modes3 = inputs3d()
    mesh3 = Mesh([str(dev)] * 2, ("points",))
    p3 = torch.from_numpy(points3).to(dev)
    s3 = torch.view_as_real(torch.from_numpy(z3)).to(dev)[None]
    f3 = torch.view_as_real(torch.from_numpy(modes3)).to(dev)[None]
    torch.cuda.synchronize()
    start = time.perf_counter()
    op3d = ShardedPlannedNufft(p3, GRID3, mesh3, transform_type="type_1",
                               tol=TOL)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - start) * 1e3
    shards = [(sh.level, sh.band_info.band if sh.band_info else None)
              for sh in op3d._shards]
    log(f"sharded 3D: {len(shards)} shards of {NUM_POINTS3 // 2} points, "
        f"(level, band) {shards}, uniform band {op3d._band}, geometry "
        f"tiles {op3d.geom.tiles} ext {op3d.geom.ext}; build "
        f"{build_ms:.1f} ms")
    if op3d.level != "binned" or op3d._band is None:
        log("sharded 3D: the shards did NOT take the banded binned level")
    banded = op3d._band is not None
    adj3d = op3d.adjoint()
    want1 = {(spread.spread_banded_cuda if banded
              else spread.spread_unplanned_cuda): 2,
             mode3d.fold3d_cuda: 2, fft3d.fine_to_modes_cuda: 6}
    want2 = {(interp.interp_banded_cuda if banded
              else interp.interp_unplanned_cuda): 2,
             mode3d.extend_tiles3d_cuda: 2, fft3d.modes_to_fine_cuda: 6}
    if op3d.level == "mats":
        want1 = {spread.spread_planned_cuda: 2, mode3d.fold3d_cuda: 2,
                 fft3d.fine_to_modes_cuda: 6}
        want2 = {interp.interp_planned_cuda: 2,
                 mode3d.extend_tiles3d_cuda: 2, fft3d.modes_to_fine_cuda: 6}
    o1 = sharded_call("3D planned type-1", lambda: op3d(s3), want1)
    o2 = sharded_call("3D planned type-2 (adjoint)", lambda: adj3d(f3),
                      want2)
    ref3 = planar.PlannedNufft(p3, GRID3, transform_type="type_1", tol=TOL)
    r1, r2 = ref3(s3), ref3.adjoint()(f3)
    sub = np.random.default_rng(SEED + 1)
    idx1 = torch.from_numpy(np.sort(sub.choice(
        int(np.prod(GRID3)), SUBSET, replace=False))).to(dev)
    idx2 = torch.from_numpy(np.sort(sub.choice(
        NUM_POINTS3, SUBSET, replace=False))).to(dev)
    for label, got, want, exact, sel in (
            ("3D planned type-1", o1, r1,
             exact_type1_subset(points3, z3, idx1, dev, grid=GRID3), idx1),
            ("3D planned type-2 (adjoint)", o2, r2,
             exact_type2_subset(points3, modes3, idx2, 1.0, dev,
                                grid=GRID3), idx2)):
        gate(label, got, want)
        err = rel(cplx(got[0]).reshape(-1)[sel], exact,
                  scale=float(cplx(want[0]).abs().max()))
        log(f"sharded {label}: err_total ({SUBSET} subset, exact NUDFT) "
            f"{err:.3e} (gate < {10 * TOL:g})")
        if not err < 10 * TOL:
            failed.append(f"{label} (exact)")
    timed("3D planned type-1", lambda: op3d(s3), lambda: ref3(s3))
    timed("3D planned type-2 (adjoint)", lambda: adj3d(f3),
          lambda: ref3.adjoint()(f3))
    if failed:
        raise RuntimeError(f"sharded phase gates failed: {failed}")
    return cases


# ---------------------------------------------------------------------------
# The suite phase: bench_suite.py's cells that no earlier phase runs, and
# the ported paths that no earlier card run checked.
# ---------------------------------------------------------------------------

SUITE_SEED = 7         # bench_suite.py's default_rng(7) (nufft_case, bigm_case)
SUITE_POINTS = 200_000
SUITE_GRID = (256, 256)
SUITE_BATCH = 16       # 2d_*_256_200k_b16_shared: B2 = 32
POINTS_1M = 1_000_000  # 3d_t1_128_1m
RADIAL = (512, 1024)   # spokes x samples of 2d_t2_512_radial_b8: 524,288
RADIAL_GRID = (512, 512)
BIGM_POINTS = 20_000_000
BIGM_GRID = (512, 512)
BIGM_MODES = 1024      # exact NUDFT modes of the 20M-point cell
F64_POINTS = 100_000   # the float64 route at tol 1e-12


def suite_case(shape, num_points=None, rank=None):
    """bench_suite.py's nufft_case inputs: default_rng(7) uniform points
    [num_points, rank] (float32; none drawn without ``num_points``), then
    complex normal values of ``shape`` (complex64)."""
    rng = np.random.default_rng(SUITE_SEED)
    points = None
    if num_points is not None:
        points = rng.uniform(-np.pi, np.pi, (num_points, rank)).astype(
            np.float32)
    values = (rng.standard_normal(shape)
              + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return points, values


def describe_geom(g):
    return (f"fine {g.fine_shape}, tiles {g.tiles} x {g.tile} ext {g.ext}, "
            f"chunk {g.chunk}, chunks {g.num_chunks}, slots {g.num_slots}")


def counted_call(phase, fn, fft_calls=0):
    """Runs the main-path call ``fn`` once with every count at 0 and no
    plain version allowed on the card path. Returns (output, launches,
    peak bytes allocated since the caller's reset_peak_memory_stats)."""
    import torch
    reset_launches()
    with no_plain_calls(phase):
        out = fn()
        torch.cuda.synchronize()
    return (out, read_launches(phase, fft_calls),
            torch.cuda.max_memory_allocated())


def reset_peak():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def cell_log(cell, smi, what, launches, ms, peak):
    log(f"suite {cell}: {what}; launches {launches}; event median "
        f"{ms:.4f} ms; peak memory {peak / 2 ** 30:.3f} GiB; {smi}")


def batch_gates(label, got, f32, ref, exacts, idx, failed):
    """The census rule (floor_gates) on batch elements: got, f32 (the
    float32 plain pipeline) and ref (the card's float64 route) are
    complex [B, ...]; each element b of ``exacts`` (b -> its exact NUDFT
    at the flat output indices ``idx``) gated alone, then err_impl of all
    B elements at max(tol, 4 * their floor_f32)."""
    for b, exact in exacts.items():
        if not floor_gates(f"{label} element {b}", got[b], f32[b], ref[b],
                           exact, idx, ref_name="float64 route"):
            failed.append(f"{label} element {b}")
    err, floor = rel(got.to(ref.dtype), ref), rel(f32.to(ref.dtype), ref)
    gate = max(TOL, 4 * floor)
    log(f"{label}: err_impl of all {got.shape[0]} elements (vs float64 "
        f"route) {err:.3e} (gate < {gate:.3e}; floor_f32 {floor:.3e}; "
        f"below tol: {err < TOL})")
    if not err < gate:
        failed.append(f"{label} err_impl")


def suite_2d(dev, smi, failed):
    """2d_t1_256_200k and the two b16_shared cells: PlannedNufft on
    bench_suite.py's 200,000 points at 256^2, batch 1 and 16 on one
    trajectory."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    points, z1 = suite_case((SUITE_POINTS,), SUITE_POINTS, 2)
    cells = (("2d_t1_256_200k", "type_1", z1[None]),
             ("2d_t2_256_200k_b16_shared", "type_2",
              suite_case((SUITE_BATCH,) + SUITE_GRID, SUITE_POINTS, 2)[1]),
             ("2d_t1_256_200k_b16_shared", "type_1",
              suite_case((SUITE_BATCH, SUITE_POINTS), SUITE_POINTS, 2)[1]))
    pts = torch.from_numpy(points).to(dev)
    x64 = pts.double()
    sub = np.random.default_rng(SEED + 20)
    idx = {"type_1": torch.from_numpy(np.sort(sub.choice(
               int(np.prod(SUITE_GRID)), SUBSET, replace=False))).to(dev),
           "type_2": torch.from_numpy(np.sort(sub.choice(
               SUITE_POINTS, SUBSET, replace=False))).to(dev)}
    ops, launches, cases = {}, {}, {}
    for cell, ttype, values in cells:
        phase = f"suite_{cell}"
        src = to_planar(values).to(dev)
        reset_peak()
        if ttype not in ops:        # the b16 type-1 cell reuses the plan
            ops[ttype] = planar.PlannedNufft(pts, SUITE_GRID,
                                             transform_type=ttype, tol=TOL)
        op = ops[ttype]
        out, launches[phase], peak = counted_call(phase,
                                                  lambda: op(src))
        cases[cell] = lambda op=op, src=src: op(src)
        cell_log(cell, smi, f"level {op.level}, {describe_geom(op.geom)}, "
                 f"batch {src.shape[0]} (B2 {2 * src.shape[0]})",
                 launches[phase], cuda_ms(cases[cell]), peak)
        kw = dict(grid_shape=SUITE_GRID) if ttype == "type_1" else {}
        ref = from_planar(planar.nufft(src.double(), x64,
                                       transform_type=ttype, tol=TOL, **kw))
        f32 = from_planar(plain_pipeline(src, pts, make_plan(PlanSpec(
            ttype, "forward", 2, SUITE_GRID, "complex64", TOL, 1))))
        exacts = {}
        for b in sorted({0, src.shape[0] - 1}):
            if ttype == "type_1":
                exacts[b] = exact_type1_subset(points, values[b], idx[ttype],
                                               dev, grid=SUITE_GRID)
            else:
                exacts[b] = exact2d_type2(
                    torch.from_numpy(values[b][None]).to(dev).to(
                        torch.complex128), x64[idx[ttype]], -1.0,
                    n=SUITE_GRID[0])[0]
        batch_gates(f"suite {cell}", from_planar(out), f32, ref, exacts,
                    idx[ttype], failed)
    return launches, cases


def suite_3d_1m(dev, smi, failed):
    """3d_t1_128_1m: PlannedNufft type-1 at 128^3 on 1,000,000 points,
    the band (or the re-plan onto the unbanded geometry) at 1M points;
    gated by the census rule (floor_gates) against the float64 route."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    points, z = suite_case((POINTS_1M,), POINTS_1M, 3)
    pts = torch.from_numpy(points).to(dev)
    src = to_planar(z[None]).to(dev)
    reset_peak()
    op = planar.PlannedNufft(pts, GRID3, transform_type="type_1", tol=TOL)
    banded = op.band_info is not None
    phase = "suite_3d_t1_128_1m" + ("" if banded else "_unbanded")
    out, launches, peak = counted_call(phase, lambda: op(src))
    form = (f"banded (band {op.band_info.band})" if banded else
            "re-planned onto the unbanded geometry")
    cell_log("3d_t1_128_1m", smi, f"level {op.level}, {form}, "
             f"{describe_geom(op.geom)} (used chunks "
             f"{int(op.binned.tile_bounds[-1])})", launches,
             cuda_ms(lambda: op(src)), peak)
    spec = dict(transform_type="type_1", fft_direction="forward", rank=3,
                grid_shape=GRID3, tol=TOL, points_range=1)
    f32 = from_planar(plain_pipeline(src, pts, make_plan(PlanSpec(
        dtype_name="complex64", **spec)))[0])
    ref = from_planar(planar.nufft(src.double(), pts.double(),
                                   grid_shape=GRID3, transform_type="type_1",
                                   tol=TOL)[0])
    idx = torch.from_numpy(np.sort(np.random.default_rng(SEED + 21).choice(
        int(np.prod(GRID3)), SUBSET, replace=False))).to(dev)
    exact = exact_type1_subset(points, z, idx, dev, grid=GRID3)
    if not floor_gates("suite 3d_t1_128_1m", from_planar(out[0]), f32, ref,
                       exact, idx, ref_name="float64 route"):
        failed.append("3d_t1_128_1m")
    return {phase: launches}, {"3d_t1_128_1m": lambda: op(src)}


def suite_radial(dev, smi, failed):
    """2d_t2_512_radial_b8 and its _slots form: PlannedNufft type-2 on
    models.mri.radial_trajectory(512, 1024) at 512^2, 8 coils sharing the
    points (points clustered at the k-space centre); then trajectory
    learning on the same points (x [8, 512, 512, 2] and k learnable)."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.models import mri
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    points = mri.radial_trajectory(*RADIAL)
    m = points.shape[0]
    _, f = suite_case((TRAIN_BATCH,) + RADIAL_GRID)
    pts = torch.from_numpy(points).to(dev)
    x = to_planar(f).to(dev)
    reset_peak()
    op = planar.PlannedNufft(pts, RADIAL_GRID, transform_type="type_2",
                             tol=TOL)
    launches = {}
    cell = "2d_t2_512_radial_b8"
    out, launches[f"suite_{cell}"], peak = counted_call(
        f"suite_{cell}", lambda: op(x))
    per_tile = torch.diff(op.binned.tile_bounds.long())
    cell_log(cell, smi, f"level {op.level}, {describe_geom(op.geom)} (used "
             f"chunks {int(op.binned.tile_bounds[-1])}; chunks a tile: max "
             f"{int(per_tile.max())}, median {int(per_tile.median())}), "
             f"{TRAIN_BATCH} coils", launches[f"suite_{cell}"],
             cuda_ms(lambda: op(x)), peak)
    x64 = pts.double()
    ref = from_planar(planar.nufft(x.double(), x64, tol=TOL))
    f32 = from_planar(plain_pipeline(x, pts, make_plan(PlanSpec(
        "type_2", "forward", 2, RADIAL_GRID, "complex64", TOL, 1))))
    idx = torch.from_numpy(np.sort(np.random.default_rng(SEED + 22).choice(
        m, SUBSET, replace=False))).to(dev)
    exacts = {b: exact2d_type2(torch.from_numpy(f[b][None]).to(dev).to(
                  torch.complex128), x64[idx], -1.0, n=RADIAL_GRID[0])[0]
              for b in (0, TRAIN_BATCH - 1)}
    batch_gates(f"suite {cell}", from_planar(out), f32, ref, exacts, idx,
                failed)

    cell = "2d_t2_512_radial_b8_slots"
    reset_peak()
    slots, launches[f"suite_{cell}"], peak = counted_call(
        f"suite_{cell}", lambda: op.apply_to_slots(x))
    cell_log(cell, smi, f"level {op.level}, {op.num_slots} slots",
             launches[f"suite_{cell}"], cuda_ms(lambda: op.apply_to_slots(x)),
             peak)
    err = rel(slots, op.to_slots(out))
    dead = bool(slots[:, op.slot_mask == 0].any())
    log(f"suite {cell}: vs to_slots of the point-order apply {err:.3e} "
        f"(gate < {KERNEL_RTOL:g}); dead slots zero: {not dead}")
    if not err <= KERNEL_RTOL or dead:
        failed.append(cell)
    cases = {"2d_t2_512_radial_b8": lambda: op(x),
             "2d_t2_512_radial_b8_slots": lambda: op.apply_to_slots(x)}
    del out, slots, ref, f32
    grad_launches, grad_cases = suite_radial_grad(pts, dev, smi, failed)
    launches.update(grad_launches)
    cases.update(grad_cases)
    return launches, cases


def suite_radial_grad(pts, dev, smi, failed):
    """Trajectory learning on the radial points: loss 0.5 |A(x; k) - y|^2
    through planar.nufft type-2, x [8, 512, 512, 2] and k learnable, y
    made with a perturbed trajectory. Gates: the points gradient against
    a float64 central difference (fd_gate); the source and points
    gradients against the float64 plain pipeline at the floor rule
    (impl_gates), and against the card's float64 route's gradients
    (autograd through planar.nufft on float64 tensors) at the same
    gates."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    rng = np.random.default_rng(SEED + 23)
    x0 = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH,) + RADIAL_GRID + (2,)).astype(np.float32)).to(dev)
    k_true = pts + torch.from_numpy((SHIFT * rng.standard_normal(
        tuple(pts.shape))).astype(np.float32)).to(dev)
    with torch.no_grad():
        y = planar.nufft(x0, k_true, tol=TOL)
    x = x0.clone().requires_grad_()
    k = pts.clone().requires_grad_()

    def step():
        out = planar.nufft(x, k, tol=TOL)
        (0.5 * (out - y).square().sum()).backward()
        return out
    cell = "radial_grad"
    reset_peak()
    out, launches, peak = counted_call(f"suite_{cell}", step)
    gx, gk = x.grad.detach().clone(), k.grad.detach().clone()
    cell_log(cell, smi, f"planar.nufft type-2 loss, x {tuple(x.shape)}, "
             f"k {tuple(k.shape)}; every count: {step_launches()}", launches,
             cuda_ms(step, reps=STEP_REPS, warmup=1), peak)
    if not (bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gk).all())):
        raise RuntimeError("suite radial_grad: non-finite gradients")
    r = (out - y).detach()
    fd_gate(f"suite {cell}", gk, pts, (("type_2", x0, r, RADIAL_GRID),),
            spread_only=False)
    x64 = x0.double().requires_grad_()
    k64 = pts.double().requires_grad_()
    (0.5 * (planar.nufft(x64, k64, tol=TOL) - y.double()).square().sum()
     ).backward()
    try:
        impl_gates(f"suite {cell}", (gx, gk), x0, pts, y, "type_2",
                   route=(x64.grad, k64.grad))
    except RuntimeError as err:
        failed.append(str(err))
    return {f"suite_{cell}": launches}, {cell: step}


def suite_bigm(dev, smi, failed):
    """2d_t1_512_20m_bigm: unplanned planar.nufft type-1 at 512^2 on
    20,000,000 points, the slot count past 2^24 (int32 slot offsets in
    the binning and the spread); err_total on 1024 modes over all points
    and err_impl against the card's float64 route, by the census rule
    (floor_gates: the float32 plain pipeline on the card gives the
    floor)."""
    import torch
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.kernels import binning
    from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar
    cell = "2d_t1_512_20m_bigm"
    points, z = suite_case((BIGM_POINTS,), BIGM_POINTS, 2)
    pts = torch.from_numpy(points).to(dev)
    src = to_planar(z).to(dev)
    plan = make_plan(PlanSpec("type_1", "forward", 2, BIGM_GRID, "complex64",
                              TOL, 1))
    geom = binning.choose_geometry(plan.fine_shape, plan.width, BIGM_POINTS)

    def call():
        return planar.nufft(src, pts, grid_shape=BIGM_GRID,
                            transform_type="type_1", tol=TOL)
    reset_peak()
    out, launches, peak = counted_call(f"suite_{cell}", call)
    cell_log(cell, smi, f"unplanned, {describe_geom(geom)}; slots "
             f"{geom.num_slots} > 2^24 ({2 ** 24}): "
             f"{geom.num_slots > 2 ** 24}", launches,
             cuda_ms(call, reps=10, warmup=1), peak)
    if not geom.num_slots > 2 ** 24:
        failed.append(f"{cell}: {geom.num_slots} slots, not past 2^24")
    idx = torch.from_numpy(np.sort(np.random.default_rng(SEED + 24).choice(
        int(np.prod(BIGM_GRID)), BIGM_MODES, replace=False))).to(dev)
    exact = exact_type1_subset(points, z, idx, dev, grid=BIGM_GRID)
    got = from_planar(out)
    del out
    ref = from_planar(planar.nufft(src.double(), pts.double(),
                                   grid_shape=BIGM_GRID,
                                   transform_type="type_1", tol=TOL))
    f32 = from_planar(plain_pipeline(src[None], pts, plan)[0])
    if not floor_gates(f"suite {cell}", got, f32, ref, exact, idx,
                       ref_name="float64 route"):
        failed.append(cell)
    return {f"suite_{cell}": launches}, {cell: call}


def suite_toeplitz3d(dev, smi, failed):
    """planar.ToeplitzNormal at 128^3 on the 3D headline's 800,000 points,
    weighted, B = 1: the spectrum's type-1 onto 256^3 (sigma 1.25 in
    float32, ROADMAP fault 3) and the apply. The float32 apply is held to
    the float64 route's Toeplitz apply and to PlannedNufft.normal with the
    same weights, under the floor rule: floor_f32 is the float32 XLA
    path's Toeplitz (Options(backend="xla")) against the float64 one."""
    import torch
    from tensorflow_nufft_tpu_torch import Options, planar
    points3, _, _ = inputs3d()
    pts = torch.from_numpy(points3).to(dev)
    rng = np.random.default_rng(SEED + 25)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, NUM_POINTS3).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((1,) + GRID3 + (2,)).astype(
        np.float32)).to(dev)
    cell = "toeplitz3d"
    ops = []

    def build():
        ops[:] = [planar.ToeplitzNormal(pts, GRID3, weights=w, tol=TOL)]
        return ops[0](x)
    reset_peak()
    # The build's one rank-3 DFT of the spectrum is torch.fft by design
    # (the JAX package's XLA contraction); the apply calls torch.fft
    # directly.
    out, launches, peak = counted_call(f"suite_{cell}", build, fft_calls=1)
    op = ops[0]
    torch.cuda.synchronize()
    start = time.perf_counter()
    planar.ToeplitzNormal(pts, GRID3, weights=w, tol=TOL)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - start) * 1e3
    cell_log(cell, smi, f"spectrum {tuple(op.spectrum.shape)} "
             f"{op.spectrum.dtype}; build {build_ms:.4f} ms (host clock)",
             launches, cuda_ms(lambda: op(x)), peak)
    ref = planar.ToeplitzNormal(pts.double(), GRID3, weights=w.double(),
                                tol=TOL)(x.double())
    floor = rel(planar.ToeplitzNormal(pts, GRID3, weights=w, tol=TOL,
                                      options=Options(backend="xla"))(x), ref)
    plan = planar.PlannedNufft(pts, GRID3, transform_type="type_2", tol=TOL)
    normal = plan.normal(x, plan.slot_weights(w))
    err_ref = rel(out, ref)
    err_normal = rel(out, normal, float(ref.abs().max()))
    gate_ref, gate_normal = max(TOL, 4 * floor), max(10 * TOL, 4 * floor)
    log(f"suite {cell}: float32 apply vs the float64 route's {err_ref:.3e} "
        f"(gate < {gate_ref:.3e}); vs PlannedNufft.normal ({plan.level}) "
        f"{err_normal:.3e} (gate < {gate_normal:.3e}); floor_f32 (float32 "
        f"XLA path vs float64) {floor:.3e}; normal vs the float64 route "
        f"{rel(normal, ref):.3e}")
    if not (err_ref < gate_ref and err_normal < gate_normal):
        failed.append(cell)
    return {f"suite_{cell}": launches}, {f"{cell}_apply": lambda: op(x)}


def suite_float64_3d(dev, smi, failed):
    """The float64 route in 3D: complex128 tnt.nufft type-1 and type-2 at
    the 3D headline (tol 1e-6, err_total < 10 * tol on 4096-element
    subsets) and at tol 1e-12 on its first 100,000 points (< 1e-10); no
    kernel launches; the time and peak memory of each call (its spread is
    the index_add_ loop of kernels/xla_ops.py)."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    points3, z3, modes3 = inputs3d()
    sub = np.random.default_rng(SEED + 26)
    cases = {}
    for m, tol, gate in ((NUM_POINTS3, TOL, 10 * TOL),
                         (F64_POINTS, 1e-12, 1e-10)):
        x64 = torch.from_numpy(points3[:m].astype(np.float64)).to(dev)
        c = torch.from_numpy(z3[:m].astype(np.complex128)).to(dev)
        f = torch.from_numpy(modes3.astype(np.complex128)).to(dev)
        idx1 = torch.from_numpy(np.sort(sub.choice(
            int(np.prod(GRID3)), SUBSET, replace=False))).to(dev)
        idx2 = torch.from_numpy(np.sort(sub.choice(m, SUBSET,
                                                   replace=False))).to(dev)
        calls = {"type_1": lambda x64=x64, c=c, tol=tol: tnt.nufft(
                     c, x64, grid_shape=GRID3, transform_type="type_1",
                     tol=tol),
                 "type_2": lambda x64=x64, f=f, tol=tol: tnt.nufft(
                     f, x64, transform_type="type_2", tol=tol)}
        for ttype, call in calls.items():
            label = f"float64_3d_{ttype[-1]}_{m}_{tol:g}"
            reset_peak()
            reset_launches()
            out = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            no_launches(f"suite {label}")
            if ttype == "type_1":
                exact = exact_type1_subset(points3[:m], z3[:m], idx1, dev,
                                           grid=GRID3)
                err = rel(out.reshape(-1)[idx1], exact)
            else:
                exact = exact_type2_subset(points3[:m], modes3, idx2, -1.0,
                                           dev, grid=GRID3)
                err = rel(out[idx2], exact)
            cell_log(label, smi, f"{m} points, tol {tol:g}, {out.dtype}",
                     {}, cuda_ms(call, reps=3, warmup=1), peak)
            log(f"suite {label}: err_total (vs exact NUDFT, {SUBSET} "
                f"elements) {err:.3e} (gate < {gate:g})")
            if not err < gate:
                failed.append(label)
            cases[label] = call
    return cases


def suite_phase(dev, smi):
    """bench_suite.py's cells and the ported paths that no earlier phase
    ran on the card, each through the entry points a user calls at its
    full size: 2d_t1_256_200k, 2d_t{2,1}_256_200k_b16_shared,
    3d_t1_128_1m, 2d_t2_512_radial_b8 (and _slots), trajectory learning
    on the radial points, 2d_t1_512_20m_bigm, the 3D ToeplitzNormal and
    the float64 route in 3D. Each cell prints its level, geometry, launch
    counts, CUDA-event median, peak memory and the card's name and power
    limit; a gate it misses fails the phase."""
    launches, cases, failed = {}, {}, []
    for cell in (suite_2d, suite_3d_1m, suite_radial, suite_bigm,
                 suite_toeplitz3d):
        got, more = cell(dev, smi, failed)
        launches.update(got)
        cases.update(more)
    cases.update(suite_float64_3d(dev, smi, failed))
    if failed:
        raise RuntimeError(f"suite phase gates failed: {failed}")
    return launches, cases


def profile_phase(label, cases, calls=20):
    """Event median, device busy time and idle share per call of each
    case (label -> zero-argument callable), with its largest device
    items. The spans' device-side ranges overlap the kernels under them
    and are not counted (``device_work``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, fn in cases.items():
        event_ms = cuda_ms(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        items = {}
        for evt in device_work(prof.events()):
            items[evt.name] = (items.get(evt.name, 0.0)
                               + evt.time_range.elapsed_us() / calls / 1e3)
        busy = sum(items.values())
        top = sorted(items.items(), key=lambda kv: -kv[1])[:4]
        log(f"profile {label} {name}: event median {event_ms:.4f} ms, "
            f"device busy {busy:.4f} ms, idle share "
            f"{1 - busy / event_ms:.3f}; largest: " + "; ".join(
                f"{k[:70]} {v:.4f} ms" for k, v in top))


def native_phase(points, z, modes, op1, op2, strengths, modes_p, dev):
    """The native engine (``Options(backend="native")``) at the 2D
    headline: builds the engine (g++), runs complex128 type-1 and type-2
    through ``tnt.nufft`` on CUDA tensors, and holds them and the float32
    planned headline to each other. Gates: the outputs stay on the card
    with no kernel launched; each within 1e-10 of the peak of the card's
    float64 route (``backend="xla"``, the JAX package's own gate); each
    within 1e-12 of the peak of ``tnt.native.nufft`` on the same numpy
    data (the same engine, with numpy's FFT in place of torch.fft); the
    float32 planned type-1 and type-2 at err_impl < tol against the
    native complex128 result, bench.py's gate, beside their err_impl
    against the port's float64 plain pipeline (the two references must
    agree within 1e-9 of the peak). Times the native calls on the host
    (median of 5, with the copies)."""
    import torch
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch import native
    from tensorflow_nufft_tpu_torch.native import engine
    from tensorflow_nufft_tpu_torch.planar import from_planar, to_planar

    start = time.perf_counter()
    if not native.available():
        engine._load()                # raises with the compiler's output
    log(f"native: engine ready in {time.perf_counter() - start:.3f} s "
        f"(g++ ran: {engine.BuildInfo.compiled}, "
        f"{engine.BuildInfo.seconds:.3f} s) -> {engine.BuildInfo.path}; "
        f"tfft_num_threads() {engine.num_threads()}")
    grid = (GRID, GRID)
    p64 = points.astype(np.float64)
    x64 = torch.from_numpy(p64).to(dev)
    host = {"type_1": z.astype(np.complex128),
            "type_2": modes.astype(np.complex128)}
    exact = {"type_1": exact2d_type1(
                 torch.from_numpy(host["type_1"]).to(dev)[None], x64,
                 -1.0)[0].cpu(),
             "type_2": exact2d_type2(
                 torch.from_numpy(host["type_2"]).to(dev)[None], x64,
                 -1.0)[0].cpu()}
    # The port's float64 plain pipeline (CPU tensors), end_to_end's
    # err_impl reference.
    pts_cpu = torch.from_numpy(p64)
    plain = {"type_1": from_planar(tnt.planar.nufft(
                 to_planar(host["type_1"]), pts_cpu, grid_shape=grid,
                 transform_type="type_1", tol=TOL)),
             "type_2": from_planar(tnt.planar.nufft(
                 to_planar(host["type_2"]), pts_cpu,
                 transform_type="type_2", tol=TOL))}
    f32 = {"type_1": from_planar(op1(strengths[None])[0]).cpu(),
           "type_2": from_planar(op2(modes_p[None])[0]).cpu()}
    times, failed = {}, []
    for kind in ("type_1", "type_2"):
        src = torch.from_numpy(host[kind]).to(dev)

        def call(backend, src=src, kind=kind):
            kw = dict(grid_shape=grid) if kind == "type_1" else {}
            return tnt.nufft(src, x64, transform_type=kind, tol=TOL,
                             options=tnt.Options(backend=backend), **kw)
        reset_launches()
        out = call("native")
        torch.cuda.synchronize()
        no_launches(f"native {kind}")
        if out.device != dev or out.dtype != torch.complex128:
            raise RuntimeError(f"native {kind}: output on {out.device}, "
                               f"{out.dtype}")
        out = out.cpu()
        err_xla = rel(out, call("xla").cpu())
        kw = dict(grid_shape=grid) if kind == "type_1" else {}
        eager = torch.from_numpy(native.nufft(
            host[kind], p64, transform_type=kind, tol=TOL, **kw))
        err_eager = rel(out, eager)
        scale = float(exact[kind].abs().max())
        refs_agree = rel(out, plain[kind])
        err_native = float((f32[kind].to(torch.complex128) - out).abs().max()
                           ) / scale
        err_plain = float((f32[kind].to(torch.complex128)
                           - plain[kind]).abs().max()) / scale
        wall = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call("native")
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        times[kind] = statistics.median(wall)
        log(f"native {kind}: on {dev}, vs the float64 route {err_xla:.3e} "
            f"(gate < 1e-10); vs tnt.native.nufft {err_eager:.3e} (gate < "
            f"1e-12); native vs f64 plain pipeline {refs_agree:.3e} (gate < "
            f"1e-9); float32 planned {kind} err_impl vs native complex128 "
            f"{err_native:.3e}, vs f64 plain pipeline {err_plain:.3e} (gate "
            f"< {TOL:g}); host time {times[kind]:.4f} ms (median of 5, "
            f"{engine.num_threads()} threads, copies included)")
        if not err_xla < 1e-10:
            failed.append(f"{kind} vs float64 route")
        if not err_eager < 1e-12:
            failed.append(f"{kind} vs tnt.native.nufft")
        if not refs_agree < 1e-9:
            failed.append(f"{kind}: the native reference and the f64 plain "
                          f"pipeline disagree ({refs_agree:.3e})")
        if not err_native < TOL:
            failed.append(f"{kind} float32 planned err_impl vs native")
    if failed:
        raise RuntimeError(f"native phase gates failed: {failed}")
    return times


# The hand-written kernels (their CUDA function names) and the spans the
# stage that launches each may run under: the spread (its window kernel
# included) under the spread span of a transform or of a type-3 outer
# spread; fold3d in the type-1 mode stage, or in a type-3 outer spread
# (which folds its tiles); the FFT kernel in either mode stage; the
# extend in the type-2 mode stage; the interp in the interp span. A
# planar Type3Plan's inner type-2 is a PlannedNufft, which has no spans,
# so its kernels run under nufft3.inner_t2.
SPAN_STAGES = {
    "spread_rows_kernel": ("nufft.spread", "nufft3.spread"),
    "spread_line_kernel": ("nufft.spread", "nufft3.spread"),
    "windows_kernel": ("nufft.spread", "nufft3.spread"),
    "fold3d_kernel": ("nufft.mode_dft_deconvolve", "nufft3.spread"),
    "fft_axis_kernel": ("nufft.mode_dft_deconvolve", "nufft.amplify_dft",
                        "nufft3.inner_t2"),
    "extend_tiles3d_kernel": ("nufft.amplify_dft", "nufft3.inner_t2"),
    "interp_rows_kernel": ("nufft.interp", "nufft3.inner_t2"),
    "interp_line_kernel": ("nufft.interp", "nufft3.inner_t2"),
}


def is_span(name):
    return name.startswith(("nufft.", "nufft3."))


def device_work(events):
    """The device activity of a profile without the spans' own ranges on
    the device timeline: any CUDA event that is a user annotation or
    bears the name of one on the host (every ``utils.profiling.scope``
    span, stage or not)."""
    from torch.autograd import DeviceType
    marks = {e.name for e in events
             if e.device_type == DeviceType.CPU and e.is_user_annotation}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.name not in marks]


class SpanIndex:
    """The stage span of each device activity of a profile: the nearest
    ``nufft.*``/``nufft3.*`` span enclosing, on the host timeline, the
    start of the runtime or driver call that launched it (the host event
    with the activity's correlation id)."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.spans = sorted((e for e in cpu if is_span(e.name)),
                            key=lambda e: e.time_range.start)
        self.launches = {e.id: e for e in cpu
                         if getattr(e, "linked_correlation_id", 0)
                         or e.name.startswith(("cuda", "cu"))}
        self.device = device_work(events)

    def span_of(self, evt):
        launch = self.launches.get(evt.id)
        if launch is None:
            return None
        t, inner = launch.time_range.start, None
        for span in self.spans:
            if span.time_range.start > t:
                break
            if t <= span.time_range.end:
                inner = span
        return inner.name if inner is not None else None


def spans_inputs():
    """The 2D and 3D headline inputs on the host: (points, z, modes)."""
    _, points, z, modes = inputs()
    return (points, z, modes), inputs3d()


def spans_phase(dev, logdir):
    """The stage spans on the card: one call each of the unplanned 2D
    type-1 and type-2 at the headline, the unplanned 3D type-1 and type-2
    at the 3D headline, the complex128 (float64 route) 2D type-1 and one
    apply of bench_suite.py's 3d_t3_500k_500k, each under
    ``torch.profiler``. Gates: each call shows its expected spans; every
    launch of a hand-written kernel sits under its stage's span
    (``SPAN_STAGES``); ``profiling.trace(logdir)`` writes a trace file.
    Prints the device ms under each span per call."""
    import pathlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    import tensorflow_nufft_tpu_torch as tnt
    from tensorflow_nufft_tpu_torch import planar
    from tensorflow_nufft_tpu_torch.planar import to_planar
    from tensorflow_nufft_tpu_torch.utils import profiling

    (p2, z2, m2), (p3, z3, m3) = spans_inputs()
    pts2, pts3 = torch.from_numpy(p2).to(dev), torch.from_numpy(p3).to(dev)
    s2, f2 = to_planar(z2).to(dev), to_planar(m2).to(dev)
    s3, f3 = to_planar(z3).to(dev), to_planar(m3).to(dev)
    c128 = torch.from_numpy(z2.astype(np.complex128)).to(dev)
    x64 = pts2.double()
    x, t, zt = type3_inputs(3, 500_000, 16.0)
    op3 = planar.Type3Plan(torch.from_numpy(x).to(dev),
                           torch.from_numpy(t).to(dev), tol=TOL)
    src3 = torch.view_as_real(torch.from_numpy(zt).to(dev))[None]
    src3 = src3.contiguous()
    del x, t, zt
    planar_t1 = ("nufft.fold_rescale", "nufft.spread",
                 "nufft.mode_dft_deconvolve")
    planar_t2 = ("nufft.fold_rescale", "nufft.amplify_dft", "nufft.interp")
    cases = {
        "2d_t1_unplanned": (lambda: planar.nufft(
            s2, pts2, grid_shape=(GRID, GRID), transform_type="type_1",
            tol=TOL), planar_t1),
        "2d_t2_unplanned": (lambda: planar.nufft(
            f2, pts2, transform_type="type_2", tol=TOL), planar_t2),
        "3d_t1_unplanned": (lambda: planar.nufft(
            s3, pts3, grid_shape=GRID3, transform_type="type_1",
            tol=TOL), planar_t1),
        "3d_t2_unplanned": (lambda: planar.nufft(
            f3, pts3, transform_type="type_2", fft_direction="backward",
            tol=TOL), planar_t2),
        "2d_t1_complex128": (lambda: tnt.nufft(
            c128, x64, grid_shape=(GRID, GRID), transform_type="type_1",
            tol=TOL), ("nufft.fold_rescale", "nufft.spread", "nufft.fft",
                       "nufft.deconvolve")),
        "3d_t3_500k_500k": (lambda: op3(src3),
                            ("nufft3.spread", "nufft3.inner_t2")),
    }
    failed = []
    for label, (fn, expect) in cases.items():
        fn()                                            # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        index = SpanIndex(prof.events())
        names = {s.name for s in index.spans}
        missing = [n for n in expect if n not in names]
        per_span, launches, outside = {}, {}, []
        for evt in index.device:
            span = index.span_of(evt)
            ms = evt.time_range.elapsed_us() / 1e3
            per_span[span or "(none)"] = per_span.get(span or "(none)",
                                                      0.0) + ms
            kernel = next((k for k in SPAN_STAGES if k in evt.name), None)
            if kernel is None:
                continue
            launches[kernel] = launches.get(kernel, 0) + 1
            if span not in SPAN_STAGES[kernel]:
                outside.append(f"{kernel} under {span}")
        log(f"spans {label}: spans {sorted(names)}; hand-written launches "
            f"{launches or 0}; device ms per span: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(per_span.items())))
        if missing:
            failed.append(f"{label}: no span {missing}")
        if outside:
            failed.append(f"{label}: {sorted(set(outside))}")
        if label != "2d_t1_complex128" and not launches:
            failed.append(f"{label}: the profile shows no hand-written "
                          f"kernel")
    logdir = pathlib.Path(logdir)
    with profiling.trace(str(logdir)):
        cases["2d_t1_unplanned"][0]()
    files = [f for f in logdir.rglob("*.json") if f.stat().st_size > 0]
    log(f"spans: profiling.trace wrote {[str(f) for f in files]}")
    if not files:
        failed.append(f"profiling.trace wrote no file under {logdir}")
    if failed:
        raise RuntimeError(f"spans phase failed: {failed}")


def timed_phase(label, fn, *args):
    """Runs a phase and prints its wall time."""
    start = time.perf_counter()
    out = fn(*args)
    log(f"{label} phase: {time.perf_counter() - start:.1f} s wall")
    return out


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
    phases = {"2d": launches}
    phases["2d_slots"] = slots_phase(
        "2d planned surface", op2, modes_p[None], strengths[None],
        torch.linalg.norm(pts, dim=1), "2d_slots")
    # Before any --profile reading: after many profiler sessions in one
    # process the profiler drops device records (on the H100, a --profile
    # run that read every phase first showed this phase's 3D type-3 with
    # no kernel at all).
    timed_phase("spans", spans_phase, dev, TRACE_DIR)
    torch.cuda.empty_cache()
    if "--profile" in sys.argv:
        profile_phase("2d", transform_cases(
            op1, op2, pts, strengths, modes_p, (GRID, GRID), {}))
    timed_phase("native", native_phase, points, z, modes, op1, op2,
                strengths, modes_p, dev)
    del op1, op2, pts, strengths, modes_p
    phases["complex2d"], cases = complex_phase_2d(points, z, modes, dev)
    if "--profile" in sys.argv:
        profile_phase("complex2d", cases)
    torch.cuda.empty_cache()
    phases["cg_sense"], cases = cg_sense_phase(dev)
    if "--profile" in sys.argv:
        profile_phase("cg_sense", cases)
    del cases
    torch.cuda.empty_cache()
    phases["perbatch"], pb_results, cases = perbatch_phase(dev)
    results.update(pb_results)
    if "--profile" in sys.argv:
        profile_phase("perbatch", cases)
    del cases
    torch.cuda.empty_cache()
    t3_launches, t3_results, cases = type3_phase(dev)
    phases.update(t3_launches)
    results.update(t3_results)
    if "--profile" in sys.argv:
        profile_phase("type3", cases)
    del cases
    torch.cuda.empty_cache()
    cases = timed_phase("sharded", sharded_phase, dev, smi)
    if "--profile" in sys.argv:
        profile_phase("sharded", cases)
    del cases
    torch.cuda.empty_cache()
    suite_launches, cases = timed_phase("suite", suite_phase, dev, smi)
    phases.update(suite_launches)
    if "--profile" in sys.argv:
        profile_phase("suite", cases)
    del cases
    torch.cuda.empty_cache()
    points3, z3, modes3 = inputs3d()
    results.update(kernel_phase_3d(points3, dev))
    torch.cuda.empty_cache()
    launches3, op1, adj, pts, strengths, modes_p = end_to_end_3d(
        points3, z3, modes3, dev)
    phases["3d"] = launches3
    phases["complex3d"] = complex_phase_3d(points3, z3, modes3, dev)
    results.update(kernel_phase_binned(op1, dev))
    phases["3d_slots"] = slots_phase(
        "3d binned level", adj, modes_p[None], strengths[None],
        torch.linalg.norm(pts, dim=1), "3d_slots")
    routes_phase_3d(op1, strengths)
    phases["3d_fused"] = fused_phase_3d(op1, strengths, modes_p)
    transform_times_3d(op1, adj, pts, strengths, modes_p)
    profile = "--profile" in sys.argv
    if profile:
        profile_phase("3d", transform_cases(
            op1, adj, pts, strengths, modes_p, GRID3,
            dict(fft_direction="backward")))
    del op1, adj, pts, strengths, modes_p
    torch.cuda.empty_cache()
    phases["planned3d_mats"], mats_results = planned_mats_phase_3d(points3,
                                                                   dev)
    results.update(mats_results)
    torch.cuda.empty_cache()
    large_phases, large_results = large_tiles_phase(points3, points, dev)
    phases.update(large_phases)
    results.update(large_results)
    torch.cuda.empty_cache()
    phases["3d_long"] = long_axis_phase(dev)
    results.update(kernel_phase_train(rng, points, points3, dev))
    train_launches, cases = train_phase_2d(points, dev)
    phases.update(train_launches)
    phases["spread_only_2d"], only2 = spread_only_phase(
        points, (2 * GRID, 2 * GRID), dev, cpu_reference=True)
    cases.update(only2)
    if profile:
        profile_phase("train2d", cases)
    del cases, only2
    torch.cuda.empty_cache()
    phases["train3d"], cases3 = train_phase_3d(points3, dev)
    phases["spread_only_3d"], only3 = spread_only_phase(
        points3, GEOMETRY3["fine_shape"], dev, cpu_reference=False)
    if profile:
        profile_phase("train3d", dict(cases3, **only3))
    del cases3, only3, points3, z3, modes3
    torch.cuda.empty_cache()
    # Rank 1.
    points1, z1, modes1 = inputs1d()
    results.update(kernel_phase_1d(points1, dev))
    torch.cuda.empty_cache()
    launches1, op1, adj, pts, strengths, modes_p = end_to_end_1d(
        points1, z1, modes1, dev)
    phases["1d"] = launches1
    with no_plain_calls("1d_slots"):
        phases["1d_slots"] = slots_phase(
            "1d binned level", adj, modes_p[None], strengths[None],
            torch.linalg.norm(pts, dim=1), "1d_slots")
    if profile:
        profile_phase("1d", transform_cases(
            op1, adj, pts, strengths, modes_p, (GRID1,),
            dict(fft_direction="backward")))
    del op1, adj, pts, strengths, modes_p, z1, modes1
    torch.cuda.empty_cache()
    mats_phases, mats_results = planned_mats_phase_1d(points1, dev)
    phases.update(mats_phases)
    results.update(mats_results)
    torch.cuda.empty_cache()
    train_launches, cases1 = train_phase_1d(points1, dev)
    phases.update(train_launches)
    torch.cuda.empty_cache()
    phases["spread_only_1d"], only1 = spread_only_phase(
        points1, GEOMETRY1["fine_shape"], dev, cpu_reference=False)
    if profile:
        profile_phase("train1d", dict(cases1, **only1))
    for name, parent in PARENT_MS.items():
        res, phase = results[name], KERNELS[name][3]
        log(f"time {name}: row-slab kernel {res['ms']:.4f} ms, "
            f"block-per-tile kernel {parent:.4f} ms (PERF.md), "
            f"bound {res['bound_ms']:.4f} ms, launches "
            f"{phases[phase][name]} in {phase}")
    for name, before in TWO_KERNEL_MS.items():
        res, phase = results[name], KERNELS[name][3]
        log(f"time {name}: this kernel {res['ms']:.4f} ms, two-kernel "
            f"design " + ("not measured" if before is None else
                          f"{before:.4f} ms (PERF.md)")
            + f", bound {res['bound_ms']:.4f} ms, launches "
            f"{phases[phase][name]} in {phase}")
    kernels = []
    for name, (_, source, replaces, phase) in KERNELS.items():
        res = results[name]
        # Its main-path phase's count, plus those of the suite cells that
        # run the kernel.
        launches = phases[phase][name] + sum(
            counts.get(name, 0) for key, counts in phases.items()
            if key.startswith("suite_"))
        kernels.append({
            "name": name, "route": "cuda", "source": _CSRC + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
