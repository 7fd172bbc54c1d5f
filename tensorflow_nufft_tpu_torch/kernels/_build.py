"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by hand with nvcc for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``, at first
use: one nvcc per source, all started together, then one link, so the
build takes as long as the slowest source. No PyTorch header is
included. The library is keyed by a hash of the sources and flags and
lives under ``build/torch_kernels/`` at the repository root.

Every C entry point returns the CUDA error of its launch
(``cudaGetLastError()``); the wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last ``library()`` call did: the .so path, whether it
    compiled, the build seconds and nvcc's output (``-Xptxas -v`` lists
    each kernel's registers, shared memory and spills)."""
    path: Optional[pathlib.Path] = None
    compiled: bool = False
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not cuda_home:
        from torch.utils.cpp_extension import CUDA_HOME
        cuda_home = CUDA_HOME
    if cuda_home and (pathlib.Path(cuda_home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "tensorflow_nufft_tpu_torch are built with nvcc at first use.")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32p, f32p = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float))
    # (planned, tile_bounds, a, coords, weights, starts, out, int params,
    #  float params, stream)
    for name in ("tnt_spread", "tnt_interp"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, i32p,
                       f32p, ptr]
        fn.restype = ctypes.c_int
    # Banded: (fused, tile_bounds, zorigins, values, coords, window
    # weights, window starts, twiddles, out, int params, float params,
    # stream) and (tile_bounds, zorigins, tiles, coords, out, int params,
    # float params, stream).
    lib.tnt_spread_banded.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, ptr,
                                      ptr, ptr, ptr, i32p, f32p, ptr]
    lib.tnt_spread_banded.restype = ctypes.c_int
    lib.tnt_interp_banded.argtypes = [ptr, ptr, ptr, ptr, ptr, i32p, f32p,
                                      ptr]
    lib.tnt_interp_banded.restype = ctypes.c_int
    # Halo kernels: (in, out, mode params, stream).
    for name in ("tnt_fold3d", "tnt_extend_tiles3d"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32p, ptr]
        fn.restype = ctypes.c_int
    # FFT along one axis: (in, out, twiddles, long twiddles, w0, w1, w2,
    # params, stream).
    lib.tnt_fft_axis.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32p,
                                 ptr]
    lib.tnt_fft_axis.restype = ctypes.c_int
    lib.tnt_error_string.argtypes = [ctypes.c_int]
    lib.tnt_error_string.restype = ctypes.c_char_p


def _compile_and_link(sources, so: pathlib.Path) -> str:
    """Compiles every source with its own nvcc, all at once, links them
    into ``so`` and returns the commands and their output. Raises if one
    fails."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}_{src.stem}.{tag}.o") for src in sources]
    jobs = []
    for src, obj in zip(sources, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = so.with_name(f"{so.name}.{tag}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    os.replace(tmp, so)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in headers + sources:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    key = digest.hexdigest()[:16]
    so = BUILD_DIR / f"libtnt_kernels_{key}.so"
    BuildInfo.path, BuildInfo.compiled = so, False
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        BuildInfo.log = _compile_and_link(sources, so)
        BuildInfo.seconds = time.perf_counter() - start
        (BUILD_DIR / f"build_{key}.log").write_text(BuildInfo.log)
        BuildInfo.compiled = True
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


# Shared memory a block may use on Hopper (227 KB of the SM's 256 KB);
# above 48 KB the launchers opt in with cudaFuncSetAttribute.
SMEM_LIMIT = 232448


def _per_axis(values, rank: int):
    """Per-axis values padded with 1 to the kernels' three axes."""
    return tuple(values) + (1,) * (3 - rank)


def kernel_params(geom, plan, batch2: int, group: int, threads: int,
                  smem: int, deriv_axis: int = -1, band: int = 0,
                  slab: int = 0, sublen: int = 0, n2: int = 0,
                  run: int = 0, lines: int = 0):
    """The (int, float) host parameter arrays of a spread or interp
    launch, in the order of ``IParam``/``FParam`` in
    ``csrc/tnt_common.cuh``. ``deriv_axis`` (-1 for none) is the axis
    whose window the unplanned interp evaluates as phi'; ``band``,
    ``slab``, ``sublen``, ``n2``, ``run`` and ``lines`` are the row-slab
    layout and the band (``Band``)."""
    horner = tuple(plan.horner) if plan.horner is not None else ()
    rank = geom.rank
    ints = ((rank,) + _per_axis(geom.tiles, rank)
            + _per_axis(geom.tile, rank) + (geom.pad,)
            + _per_axis(geom.ext, rank)
            + (geom.chunk, batch2, group, geom.num_slots, plan.width,
               len(horner), threads, smem, deriv_axis, band, slab, sublen,
               n2, run, lines))
    hw = float(plan.half_width)
    floats = (hw, 2.0 / (hw * hw), plan.beta, plan.c) + horner
    # ctypes.c_float rounds each double to float32, as the plain
    # version's np.float32 constants do.
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def mode_params(geom, batch: int, axes: int, launch):
    """The int parameter array of a rank-3 halo-kernel launch, in the
    order of ``ModeParam`` in ``csrc/mode3d.cu``: ``axes`` leading axes
    tiled (2 for the fused route, whose ``geom`` then describes
    [nt0, nt1, 1] tiles of (t0, t1, n2)), and the ``launch``
    (``mode3d.halo_launch``)."""
    ints = ((batch,) + tuple(geom.fine_shape) + tuple(geom.tiles)
            + tuple(geom.tile) + (geom.pad, axes) + tuple(launch))
    return (ctypes.c_int * len(ints))(*ints)


def require_cuda(kernel: str, t, name: str, dtype, shape) -> None:
    """Raises unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what the kernels take, checked before any pointer is
    passed to them."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel} kernel: {name} must be a contiguous CUDA {dtype} "
            f"tensor of shape {tuple(shape)}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def check(rc: int, what: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().tnt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
