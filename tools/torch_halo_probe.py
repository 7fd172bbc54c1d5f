"""Probe of the PyTorch port's 3D halo kernels on one GPU.

Prints the SHA-256 of the outputs of ``extend_tiles3d_cuda``,
``fold3d_cuda`` and ``fold2_cuda`` on seeded inputs, with their
CUDA-event medians, beside the one-call PyTorch library time of the
same function and the bound, at the geometries the 3D main path gives
them:

- the unbanded 3D headline (128^3 modes, 800,000 points, tol 1e-6):
  fine 256^3, 1024 tiles of ext (24, 24, 72), batch 1 and 3;
- the binned level's banded geometry there: 128 tiles of ext
  (136, 24, 72), and its fused route's y [2, 16, 2, 136, 24, 128]
  (fold2);
- the large-tile cell (256^3 modes, width 10): fine 320^3, 2000 tiles
  of ext (32, 32, 80);
- small geometries with 1 and 2 tiles on an axis (hashes and times).

Library calls (not used by the port; the yardstick of a gather and a
scatter-add): extend is one ``torch.take`` of ``torch.view_as_real(
fine)`` with a cached int64 index of the tile array's shape; fold is a
zero-filled float32 grid and one ``index_add_`` of the flat tile array
with the same index (both built outside the timed region). Bound: the
tile array and the grid each moved once at 3.35 TB/s (H100 SXM).

The hashes let two trees be compared bit for bit: run the probe with
this tree's package and with another checkout's first on PYTHONPATH, in
turns (parent, change, change, parent):

    PYTHONPATH=<other tree> python3 tools/torch_halo_probe.py --device
    PYTHONPATH=. python3 tools/torch_halo_probe.py --device

Only the kernels' wrappers are called, so any tree with the rank-3 mode
stage runs it.

--fft     instead times the rank-3 mode stages on the FFT kernel: the
          type-2 stage (modes to the fine grid), the type-1 stage (the
          fine grid to the modes) and the fused route's two-axis stage,
          at the 3D headline (batch 1 and 3), the large-tile cell and the
          fused shape, with their launches counted and the SHA-256 of
          their outputs after adding +0.0 (signed zeros aside), beside
          the cuFFT route (the plain stage: amplify_pad_plain or
          truncate_deconvolve_plain around torch.fft) and two bounds (the
          stage's input and output once; the bytes the pruned passes
          move). A tree whose stage is amplify_pad3d_cuda or
          truncate_deconvolve3d/2_cuda around fft3d_cuda runs those.
          Then the full-grid FFT kernel (``kernels.fft3d.fft3d_cuda``)
          at the 3D fine grids beside torch.fft; with --sweep at each
          launch setting (lines a block 4-32, shared-memory target 48 or
          160 KB).
--device  also prints each call's device time: the CUDA kernels' time
          per call from torch.profiler over 20 calls, or "not
          measured" with the reason where the profiler missed a launch
          or read a time below the bound.
"""

import hashlib
import statistics
import subprocess
import sys

import numpy as np
import torch

import tensorflow_nufft_tpu_torch
from tensorflow_nufft_tpu_torch.kernels import binning, mode3d
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan

PEAK_BYTES_PER_S = 3.35e12
NUM_POINTS = 800_000


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of ``fn`` in ms (CUDA events around each call)."""
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


def device_ms(fn, kernel=None, calls=20, per_call=1):
    """Device time per call of ``fn``: the CUDA kernels' summed time
    under torch.profiler, / ``calls``. Raises unless the profiler saw
    every launch: exactly ``per_call`` kernels a call, each named with
    ``kernel`` (one of the port's wrappers; a tuple: one of those
    names), where it is given, else the same number of kernels in each
    call (a library call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = (kernel,) if isinstance(kernel, str) else kernel or ()
    named = [e for e in events if any(k in e.name for k in names)]
    want = calls * per_call
    if (len(named) != want or len(events) != want) if kernel else (
            not events or len(events) % calls):
        raise RuntimeError(
            f"the profiler saw {len(events)} kernels ({len(named)} named "
            f"{kernel!r}) in {calls} calls: "
            f"{sorted({e.name for e in events})}")
    events.sort(key=lambda e: e.time_range.start)
    device_ms.per_launch = [
        sum(e.time_range.elapsed_us() for e in events[i::per_call]) / calls
        / 1e3 for i in range(per_call)] if kernel else []
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3


def sha(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def library_call(kind, geom, batch, source, out, axes=3):
    """The one PyTorch call that computes the halo kernel ``kind`` on
    ``source`` (the yardstick; the port never calls it): a gather,
    ``torch.take`` of the grid's float32 view, for "extend"; a zero fill
    and one ``index_add_`` of the flat tile array for "fold". Both use an
    int64 index of the tile array's shape [*tiles, 2B, *ext] (axes 2: y
    [nt0, nt1, 2B, E0, E1, n2]) into the flat float32 view of the grid
    [B, *fine, 2], built here, outside the timed call. Raises unless the
    call gives the kernel's output ``out``."""
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
        same = err <= 1e-5 * float(want.abs().max())
    if not same:
        raise RuntimeError(f"the {kind} library call computes another "
                           f"function")
    return call


def geometry(grid, banded=False, points=NUM_POINTS, tile_pref=0):
    plan = make_plan(PlanSpec("type_1", "forward", 3, grid, "complex64",
                              1e-6, 1))
    return binning.choose_geometry(plan.fine_shape, plan.width, points,
                                   tile_pref=tile_pref, banded=banded)


def cases():
    """(tag, geometry, batch, kind) of every probed call; kind "fold2"
    folds the fused route's y of a geometry (its n2 = fine2 / 2)."""
    head = geometry((128, 128, 128))
    band = geometry((128, 128, 128), banded=True)
    large = geometry((256, 256, 256))
    for geom, ext in ((head, (24, 24, 72)), (band, (136, 24, 72)),
                      (large, (32, 32, 80))):
        if geom.ext != ext:
            raise RuntimeError(f"geometry {geom} has ext {geom.ext}, not "
                               f"{ext}")
    out = []
    for tag, geom, batch in (("3d", head, 1), ("3d_b3", head, 3),
                             ("3d_banded", band, 1),
                             ("3d_large", large, 1),
                             ("1_tile", geometry((16, 16, 16), points=3000,
                                                 tile_pref=32), 2),
                             ("2_tiles", geometry((64, 16, 16), True,
                                                  3000), 2)):
        out += [(tag, geom, batch, "extend"), (tag, geom, batch, "fold")]
    out.append(("3d_fused", band, 1, "fold2"))
    return out


def run(tag, geom, batch, kind, device):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(61)
    axes, g = 3, geom
    if kind == "fold2":
        n2 = geom.fine_shape[2] // 2
        axes, g = 2, mode3d._modes2_geometry(geom, n2)
        shape = geom.tiles[:2] + (2 * batch,) + geom.ext[:2] + (n2,)
    else:
        shape = geom.tiles + (2 * batch,) + geom.ext
    fine_cells = batch * int(np.prod(g.fine_shape))
    if kind == "extend":
        source = torch.complex(*(torch.randn(
            (batch,) + geom.fine_shape, generator=gen, device=dev)
            for _ in range(2)))
        fn = lambda: mode3d.extend_tiles3d_cuda(source, geom)
    else:
        source = torch.randn(shape, generator=gen, device=dev)
        fn = (lambda: mode3d.fold3d_cuda(source, geom, batch)) \
            if kind == "fold" else (lambda: mode3d.fold2_cuda(
                source, geom, batch))
    got = fn()
    lib = library_call("extend" if kind == "extend" else "fold", g, batch,
                       source, got, axes)
    nbytes = 4 * int(np.prod(shape)) + 8 * fine_cells
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    line = (f"{tag} {kind} tiles {tuple(shape)} launch "
            f"{launch(geom, batch, kind)}: {sha(got)} "
            f"{cuda_ms(fn):.4f} ms, library {cuda_ms(lib):.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes:.4e} B)")
    if device:
        name = "extend_tiles3d" if kind == "extend" else "fold3d"
        try:
            ms, lib_ms = device_ms(fn, name), device_ms(lib)
            if min(ms, lib_ms) < bound_ms:
                raise RuntimeError(f"a device time ({ms:.4f}, {lib_ms:.4f} "
                                   f"ms) below the bound is a misreading")
            line += f", device {ms:.4f} ms, library device {lib_ms:.4f} ms"
        except RuntimeError as err:
            line += f", device not measured ({err})"
    print(line, flush=True)


def fft_rows(device, sweep):
    """fft3d_cuda (forward) at the 3D headline's fine grid, the
    large-tile cell's and the fused route's two axes, beside torch.fft
    (cuFFT) and the bound (the grid read and written once), at each
    (lines a block, shared-memory target) launch setting of ``sweep``
    (default: the tree's own). The hashes do not depend on the
    setting."""
    from tensorflow_nufft_tpu_torch.kernels import fft3d
    gen = torch.Generator(device="cuda").manual_seed(62)
    for shape, dims in (((1, 256, 256, 256), (1, 2, 3)),
                        ((1, 320, 320, 320), (1, 2, 3)),
                        ((1, 256, 256, 128), (1, 2))):
        x = torch.complex(*(torch.randn(shape, generator=gen, device="cuda")
                            for _ in range(2)))
        lib = lambda: fft3d.fft_plain(x, dims, "forward")
        bound_ms = 16 * x.numel() / PEAK_BYTES_PER_S * 1e3
        for cols, target in sweep or [(fft3d.FFT_MAX_COLS,
                                       fft3d.FFT_SMEM_TARGET)]:
            fft3d.FFT_MAX_COLS, fft3d.FFT_SMEM_TARGET = cols, target
            fn = lambda: fft3d.fft3d_cuda(x, dims, "forward")
            line = (f"fft {shape} dims {dims} cols {cols} smem target "
                    f"{target}: {sha(fn())} {cuda_ms(fn):.4f} ms, library "
                    f"{cuda_ms(lib):.4f} ms, bound {bound_ms:.4f} ms")
            if device:
                try:
                    ms = device_ms(fn, "fft_axis", per_call=len(dims))
                    line += (f", device {ms:.4f} ms, library device "
                             f"{device_ms(lib):.4f} ms")
                except RuntimeError as err:
                    line += f", device not measured ({err})"
            print(line, flush=True)
        del x
        torch.cuda.empty_cache()


def sha0(t):
    """The SHA-256 of ``t`` after adding +0.0 (-0.0 becomes +0.0)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return sha(t + 0.0)


def stage_fns(plan, kind, x):
    """(fn, kernel names, wrappers) of the tree's ``kind`` mode stage on
    ``x``: "to_fine" (modes -> fine grid), "to_modes" (fine grid ->
    modes) or "to_modes2" (the fused route's [B, nf0, nf1, n2] ->
    modes)."""
    from tensorflow_nufft_tpu_torch.kernels import fft3d
    direction = plan.spec.fft_direction
    if hasattr(fft3d, "modes_to_fine_cuda"):
        if kind == "to_fine":
            return ((lambda: fft3d.modes_to_fine_cuda(x, plan)),
                    ("fft_axis",), (fft3d.modes_to_fine_cuda,))
        axes = 2 if kind == "to_modes2" else 3
        return ((lambda: fft3d.fine_to_modes_cuda(x, plan, axes)),
                ("fft_axis",), (fft3d.fine_to_modes_cuda,))
    geom = binning.choose_geometry(plan.fine_shape, plan.width, NUM_POINTS)
    if kind == "to_fine":
        return ((lambda: fft3d.fft3d_cuda(mode3d.amplify_pad3d_cuda(
                    x, plan, geom), (1, 2, 3), direction)),
                ("fft_axis", "amplify_pad3d"),
                (fft3d.fft3d_cuda, mode3d.amplify_pad3d_cuda))
    if kind == "to_modes":
        return ((lambda: mode3d.truncate_deconvolve3d_cuda(fft3d.fft3d_cuda(
                    x, (1, 2, 3), direction), plan, geom)),
                ("fft_axis", "truncate_deconvolve3d"),
                (fft3d.fft3d_cuda, mode3d.truncate_deconvolve3d_cuda))
    return ((lambda: mode3d.truncate_deconvolve2_cuda(fft3d.fft3d_cuda(
                x, (1, 2), direction), plan, geom)),
            ("fft_axis", "truncate_deconvolve3d"),
            (fft3d.fft3d_cuda, mode3d.truncate_deconvolve2_cuda))


def plain_stage(plan, kind, x):
    """The cuFFT route of a stage: the plain mode end around torch.fft."""
    from tensorflow_nufft_tpu_torch.kernels import fft3d
    direction = plan.spec.fft_direction
    if kind == "to_fine":
        return lambda: fft3d.fft_plain(mode3d.amplify_pad_plain(x, plan),
                                       (1, 2, 3), direction)
    axes = 2 if kind == "to_modes2" else 3
    return lambda: mode3d.truncate_deconvolve_plain(fft3d.fft_plain(
        x, (1, 2, 3)[:axes], direction), plan, axes)


def stage_bytes(plan, batch, kind):
    """(bytes of the stage's input and output once, bytes its pruned
    passes move: each pass's input and output once)."""
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    cells = {"to_fine": [n0 * n1 * n2, n0 * n1 * f2, n0 * f1 * f2,
                         f0 * f1 * f2],
             "to_modes": [f0 * f1 * f2, f0 * f1 * n2, f0 * n1 * n2,
                          n0 * n1 * n2],
             "to_modes2": [f0 * f1 * n2, f0 * n1 * n2, n0 * n1 * n2]}[kind]
    return (8 * batch * (cells[0] + cells[-1]),
            8 * batch * sum(a + b for a, b in zip(cells, cells[1:])))


def stage_rows(device):
    """The rank-3 mode stages at the 3D headline (batch 1 and 3), the
    large-tile cell and the fused shape: hashes, launches, times."""
    gen = torch.Generator(device="cuda").manual_seed(63)
    rows = []
    for grid, batch in (((128, 128, 128), 1), ((128, 128, 128), 3),
                        ((256, 256, 256), 1)):
        rows += [(grid, batch, "to_fine", "backward"),
                 (grid, batch, "to_modes", "forward")]
    rows.append(((128, 128, 128), 1, "to_modes2", "forward"))
    for grid, batch, kind, direction in rows:
        plan = make_plan(PlanSpec("type_1", direction, 3, grid, "complex64",
                                  1e-6, 1))
        if kind == "to_fine":
            x = torch.randn((batch,) + grid + (2,), generator=gen,
                            device="cuda")
        else:
            shape = plan.fine_shape[:2] + (
                grid[2] if kind == "to_modes2" else plan.fine_shape[2],)
            x = torch.complex(*(torch.randn((batch,) + shape, generator=gen,
                                            device="cuda")
                                for _ in range(2)))
        fn, names, counters = stage_fns(plan, kind, x)
        before = sum(c.launches for c in counters)
        out = fn()
        launches = sum(c.launches for c in counters) - before
        lib = plain_stage(plan, kind, x)
        nbytes, moved = stage_bytes(plan, batch, kind)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        line = (f"stage {kind} modes {grid} fine {plan.fine_shape} batch "
                f"{batch}: {sha0(out)} launches {launches}, "
                f"{cuda_ms(fn):.4f} ms, cuFFT route {cuda_ms(lib):.4f} ms, "
                f"bound {bound_ms:.4f} ms ({nbytes:.4e} B), pruned passes' "
                f"bound {moved / PEAK_BYTES_PER_S * 1e3:.4f} ms "
                f"({moved:.4e} B)")
        if device:
            try:
                ms = device_ms(fn, names, per_call=launches)
                each = " + ".join(f"{t:.4f}" for t in device_ms.per_launch)
                line += (f", device {ms:.4f} ms ({each}), cuFFT route device "
                         f"{device_ms(lib):.4f} ms")
            except RuntimeError as err:
                line += f", device not measured ({err})"
        print(line, flush=True)
        del x, out
        torch.cuda.empty_cache()


def launch(geom, batch, kind):
    """The tree's launch plan where it has one."""
    plan = getattr(mode3d, "halo_launch", None)
    if plan is None:
        return "grid-stride"
    if kind == "fold2":
        n2 = geom.fine_shape[2] // 2
        return plan(mode3d._modes2_geometry(geom, n2), batch, "fold", 2)
    return plan(geom, batch, kind)


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
    if "--fft" in sys.argv:
        sweep = [(c, t * 1024) for c in (4, 8, 16, 32) for t in (48, 160)] \
            if "--sweep" in sys.argv else None
        from tensorflow_nufft_tpu_torch.kernels import fft3d
        for cols, target in sweep or [(fft3d.FFT_MAX_COLS,
                                       fft3d.FFT_SMEM_TARGET)]:
            fft3d.FFT_MAX_COLS, fft3d.FFT_SMEM_TARGET = cols, target
            print(f"launch setting: at most {cols} lines a block, shared "
                  f"memory target {target} B", flush=True)
            stage_rows("--device" in sys.argv)
        fft_rows("--device" in sys.argv, sweep)
        return
    for case in cases():
        run(*case, device="--device" in sys.argv)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
