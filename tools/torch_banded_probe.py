"""Probe of the PyTorch port's banded spread and interp kernels on one GPU.

At the 3D headline (128^3 modes, 800,000 uniform points, tol 1e-6, seed
42; the binned plan level) it prints the SHA-1 of both kernels' outputs
on seeded inputs and their CUDA-event medians. The hashes let two trees
be compared bit for bit: run the probe once with this tree and once with
another checkout's package first on PYTHONPATH (only the default mode
runs against a tree whose launch shapes differ).

--sweep   also times other launch shapes (spread: rows a block, one or
          two channels a warp; interp: piece rows and sub-chunks a
          block), each held to the default launch bit for bit.
--cycles  also builds a copy of csrc with clock64 counters in the spread
          (under build/torch_probe/) and prints, for the banded spread,
          SM cycles per hit and warp, hits per 32-slot test, and the
          block cycles summed over the card against its SM cycles
          (tools/torch_unbanded_probe.py --cycles: the unbanded one).

Usage: python3 tools/torch_banded_probe.py [--sweep] [--cycles]
"""

import ctypes
import hashlib
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu_torch.kernels import _build, binning, interp, spread

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cuda_ms(fn, reps=20, warmup=3):
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


def sha(t):
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]


def headline():
    """The binned-level plan and the kernels' calls on seeded inputs."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    pts = rng.uniform(-np.pi, np.pi, (800_000, 3)).astype(np.float32)
    op = tnt.PlannedNufft(pts, (128, 128, 128), "type_1")
    geom, tb, band = op.geom, op.binned.tile_bounds, op.band_info
    gen = torch.Generator(device=dev).manual_seed(52)
    vals = binning.build_values_payload(
        torch.randn((2, 800_000), generator=gen, device=dev), op.binned)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    return (op, lambda: spread.spread_banded_cuda(
                vals, tb, geom, op.plan, op.coords, band),
            lambda: interp.interp_banded_cuda(
                tiles, tb, geom, op.plan, op.coords, band))


def sweep(op, sp, ip):
    e0, e1, e2 = op.geom.ext
    w = op.plan.width
    want = sp()
    real = spread.banded_shape
    try:
        for group, slab in ((2, 7), (2, 3), (2, 4), (2, 14), (1, 6),
                            (1, 13)):
            shape = (group, slab, 32 * slab,
                     4 * slab * (group * e1 * e2 + 64 * w))
            spread.banded_shape = lambda *a, _s=shape, **k: _s
            same = torch.equal(sp(), want)
            print(f"spread channels/warp {group} rows/block {slab}: "
                  f"{cuda_ms(sp):.4f} ms, equal {same}", flush=True)
    finally:
        spread.banded_shape = real
    want = ip()
    real = interp.banded_shape
    plane = 4 * e1 * e2
    try:
        for rows, run in ((8, 4), (4, 4), (16, 4), (8, 2), (8, 1)):
            shape = (rows, run, run * 128, 2 * rows * plane)
            interp.banded_shape = lambda *a, _s=shape, **k: _s
            same = torch.equal(ip(), want)
            print(f"interp piece rows {rows} sub-chunks/block {run}: "
                  f"{cuda_ms(ip):.4f} ms, equal {same}", flush=True)
    finally:
        interp.banded_shape = real


# (anchor in csrc/spread.cu, text, whether it goes before the anchor)
# for the counters.
_COUNTERS = (
    ("namespace {\n", "__device__ unsigned long long g_probe[6];\n", False),
    ("  const bool split = !kBanded && nq < g.e[1];\n",
     "  const long long probe_t0 = clock64();\n"
     "  unsigned long long probe_hits = 0, probe_tests = 0;\n", False),
    ("        unsigned m = __ballot_sync(0xffffffffu, hit);\n",
     "        probe_hits += __popc(m);\n        probe_tests += 1;\n", False),
    ("}\n\n// The spread: block",
     "  if (lane == 0) {\n"
     "    atomicAdd(&g_probe[0], (unsigned long long)(clock64() - probe_t0));\n"
     "    atomicAdd(&g_probe[1], probe_hits);\n"
     "    atomicAdd(&g_probe[2], probe_tests);\n"
     "  }\n", True),
    ("  if constexpr (!kFused) {\n", "  const long long probe_b0 = clock64();\n",
     True),
    ("          dst[(size_t)r * e1 * line + i] = acc[c * stride + r * sub + i];"
     "\n    }\n",
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&g_probe[3], (unsigned long long)(clock64() - probe_b0));\n"
     "      atomicAdd(&g_probe[4], 1ull);\n"
     "    }\n", False),
)


def cycles(sp):
    """Rebuilds the kernels with counters and runs the spread ``sp`` (the
    banded or the unbanded one: both warps' loops are counted) once."""
    out = ROOT / "build" / "torch_probe"
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*"):
        text = f.read_text()
        if f.name == "spread.cu":
            for anchor, extra, before in _COUNTERS:
                if anchor not in text:
                    raise RuntimeError(f"probe anchor not found: {anchor!r}")
                at = text.index(anchor) + (0 if before else len(anchor))
                text = text[:at] + extra + text[at:]
            text += ('\nextern "C" int tnt_probe(unsigned long long* out, '
                     'int reset) {\n  if (reset) {\n'
                     '    unsigned long long z[6] = {0};\n'
                     '    return (int)cudaMemcpyToSymbol(g_probe, z, '
                     'sizeof(z));\n  }\n'
                     '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
                     '6 * sizeof(unsigned long long));\n}\n')
        (out / "csrc" / f.name).write_text(text)
    _build._lib = None
    _build.CSRC, _build.BUILD_DIR = out / "csrc", out / "lib"
    lib = _build.library()
    lib.tnt_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 6)()
    sp()
    torch.cuda.synchronize()
    lib.tnt_probe(buf, 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sp()
    end.record()
    end.synchronize()
    lib.tnt_probe(buf, 0)
    warp_cycles, hits, tests, block_cycles, blocks, _ = list(buf)
    ms = start.elapsed_time(end)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_cycles = sms * ms * 1e3 * mhz
    print(f"counters: {ms:.4f} ms; {hits} warp hits, "
          f"{warp_cycles / hits:.1f} SM cycles per hit and warp, "
          f"{hits / tests:.2f} hits per 32-slot test; {blocks} blocks, "
          f"block cycles summed / card SM cycles at {mhz:.0f} MHz "
          f"{block_cycles / sm_cycles:.2f}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: the probe "
                         "needs an NVIDIA GPU")
    op, sp, ip = headline()
    print(f"spread {sha(sp())} {cuda_ms(sp):.4f} ms; "
          f"interp {sha(ip())} {cuda_ms(ip):.4f} ms", flush=True)
    if "--sweep" in sys.argv:
        sweep(op, sp, ip)
    if "--cycles" in sys.argv:
        cycles(sp)


if __name__ == "__main__":
    main()
