"""ctypes bindings of the native C++/OpenMP spread/interp engine.

The engine is the repository's ``cc/nufft_cpu.cc``, the JAX package's
host engine, compiled as it stands with the JAX package's g++ flags into
a plain-C shared library under ``build/torch_kernels/`` (beside the
CUDA kernels' library, ``kernels._build``) at first use, and loaded with
``ctypes``; it takes about a second to build. The library is keyed by a
hash of the source, the compiler, the flags and the host CPU (a
``-march=native`` binary must not run on another CPU), and is written
to a temporary file and renamed, so processes that build at once do not
collide.

Where the engine cannot be built (no compiler), ``spread``/``interp``
raise ``RuntimeError`` with the compiler's output; ``available()`` says
whether it can be.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import threading
import time

import numpy as np

from tensorflow_nufft_tpu_torch.kernels._build import BUILD_DIR

SOURCE = (pathlib.Path(__file__).resolve().parents[2] / "cc"
          / "nufft_cpu.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")
# The engine's window buffers hold MAX_KERNEL_WIDTH = 16 taps
# (cc/nufft_cpu.cc): a wider width would overflow them.
MAX_WIDTH = 16

_LOCK = threading.Lock()


class BuildInfo:
    """What the last load did: the .so path, whether it compiled and the
    build seconds."""
    path = None
    compiled = False
    seconds = 0.0


def lib_path() -> pathlib.Path:
    """Where this source, compiler, flags and CPU's library lives."""
    tag = hashlib.sha256(
        SOURCE.read_bytes()
        + CXX.encode()
        + platform.machine().encode()
        + platform.processor().encode()
        + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtnt_cpu_{tag}.so"


def _build() -> pathlib.Path:
    so = lib_path()
    BuildInfo.path, BuildInfo.compiled = so, False
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    start = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(
            f"cannot build the native engine: {CXX} did not run ({e})"
        ) from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"cannot build the native engine: {CXX} exited "
            f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, so)
    BuildInfo.seconds = time.perf_counter() - start
    BuildInfo.compiled = True
    return so


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    with _LOCK:
        lib = ctypes.CDLL(str(_build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    for suffix, fp in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fpp = ctypes.POINTER(fp)
        for op in ("spread", "interp"):
            fn = getattr(lib, f"tfft_{op}_{suffix}")
            fn.restype = None
            fn.argtypes = [
                ctypes.c_int, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_double, ctypes.c_int,
                f64p, fpp, fpp,       # points are always double
            ]
    lib.tfft_num_threads.restype = ctypes.c_int
    lib.tfft_num_threads.argtypes = []
    return lib


def available() -> bool:
    """True if the native engine can be built and loaded on this host."""
    try:
        _load()
        return True
    except Exception:
        return False


def num_threads() -> int:
    """The OpenMP threads the engine runs on (``tfft_num_threads``)."""
    return int(_load().tfft_num_threads())


def _check(width: int, points: np.ndarray, grid_shape) -> np.ndarray:
    """Validates what the engine reads through raw pointers (the width
    bounds its stack buffers; the points' rank is the grid's) and
    returns the points as contiguous float64."""
    if not 1 <= int(width) <= MAX_WIDTH:
        raise ValueError(
            f"native engine supports kernel widths 1..16, got {width}")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != len(grid_shape):
        raise ValueError(
            f"points must have shape [M, {len(grid_shape)}] for the grid "
            f"{tuple(grid_shape)}, got {points.shape}")
    return pts


def _real_dtype(arr: np.ndarray):
    return np.float32 if arr.dtype == np.complex64 else np.float64


def _complex_dtype(real_dt):
    return np.complex64 if real_dt == np.float32 else np.complex128


def _interleaved(arr: np.ndarray, real_dt) -> np.ndarray:
    """complex array -> contiguous interleaved real view (or copy)."""
    return np.ascontiguousarray(arr, dtype=_complex_dtype(real_dt)).view(
        real_dt)


def _call(op: str, real_dt, dims, num_points, batch, width, beta,
          num_threads, points, a, b):
    suffix = "f32" if real_dt == np.float32 else "f64"
    fn = getattr(_load(), f"tfft_{op}_{suffix}")
    fp = ctypes.POINTER(ctypes.c_float if real_dt == np.float32
                        else ctypes.c_double)
    dims = np.asarray(dims, dtype=np.int64)
    fn(len(dims), dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       num_points, batch, width, float(beta), num_threads,
       points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
       a.ctypes.data_as(fp), b.ctypes.data_as(fp))


def spread(strengths: np.ndarray, points_resc: np.ndarray,
           fine_shape, width: int, beta: float,
           num_threads: int = 0) -> np.ndarray:
    """[batch, M] complex strengths + [M, rank] rescaled points (float64,
    in [0, nf)) -> [batch, *fine_shape] complex fine grid."""
    pts = _check(width, points_resc, fine_shape)
    num_points = pts.shape[0]
    batch = strengths.shape[0]
    real_dt = _real_dtype(strengths)
    s = _interleaved(strengths.reshape(batch, num_points), real_dt)
    fine = np.zeros((batch,) + tuple(fine_shape) + (2,), dtype=real_dt)
    _call("spread", real_dt, fine_shape, num_points, batch, width, beta,
          num_threads, pts, s, fine)
    return fine.view(_complex_dtype(real_dt))[..., 0]


def interp(fine: np.ndarray, points_resc: np.ndarray, width: int,
           beta: float, num_threads: int = 0) -> np.ndarray:
    """[batch, *fine_shape] complex grid + [M, rank] rescaled points ->
    [batch, M] complex values."""
    pts = _check(width, points_resc, fine.shape[1:])
    num_points = pts.shape[0]
    batch = fine.shape[0]
    real_dt = _real_dtype(fine)
    f = _interleaved(fine, real_dt)
    vals = np.zeros((batch, num_points, 2), dtype=real_dt)
    _call("interp", real_dt, fine.shape[1:], num_points, batch, width, beta,
          num_threads, pts, f, vals)
    return vals.view(_complex_dtype(real_dt))[..., 0]
