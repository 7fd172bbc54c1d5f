"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by hand with nvcc for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``, at first
use. No PyTorch header is included, so a build takes seconds. The library
is keyed by a hash of the sources and flags and lives under
``build/torch_kernels/`` at the repository root.

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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    lib.tnt_error_string.argtypes = [ctypes.c_int]
    lib.tnt_error_string.restype = ctypes.c_char_p


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
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sources)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        BuildInfo.seconds = time.perf_counter() - start
        BuildInfo.log = proc.stdout + proc.stderr
        (BUILD_DIR / f"build_{key}.log").write_text(
            " ".join(cmd) + "\n" + BuildInfo.log)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{BuildInfo.log}")
        os.replace(tmp, so)
        BuildInfo.compiled = True
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


# Shared memory a block may use on Hopper (227 KB of the SM's 256 KB);
# above 48 KB the launchers opt in with cudaFuncSetAttribute.
SMEM_LIMIT = 232448


def kernel_params(geom, plan, batch2: int, group: int, threads: int,
                  smem: int):
    """The (int, float) host parameter arrays of a launch, in the order
    of ``IParam``/``FParam`` in ``csrc/tnt_common.cuh``."""
    horner = tuple(plan.horner) if plan.horner is not None else ()
    ints = (geom.tiles[0], geom.tiles[1], geom.tile[0], geom.tile[1],
            geom.pad, geom.ext[0], geom.ext[1], geom.chunk, batch2, group,
            geom.num_slots, plan.width, len(horner), threads, smem)
    hw = float(plan.half_width)
    floats = (hw, 2.0 / (hw * hw), plan.beta, plan.c) + horner
    # ctypes.c_float rounds each double to float32, as the plain
    # version's np.float32 constants do.
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


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
