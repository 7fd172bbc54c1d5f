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

--fft     instead times the FFT kernel (``kernels.fft3d.fft3d_cuda``)
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
    ``kernel``, where it is given (one of the port's wrappers), else the
    same number of kernels in each call (a library call)."""
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
    named = [e for e in events if kernel is not None and kernel in e.name]
    want = calls * per_call
    if (len(named) != want or len(events) != want) if kernel else (
            not events or len(events) % calls):
        raise RuntimeError(
            f"the profiler saw {len(events)} kernels ({len(named)} named "
            f"{kernel!r}) in {calls} calls: "
            f"{sorted({e.name for e in events})}")
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
        fft_rows("--device" in sys.argv, sweep)
        return
    for case in cases():
        run(*case, device="--device" in sys.argv)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
