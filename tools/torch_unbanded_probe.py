"""Probe of the PyTorch port's unbanded spread and interp kernels on one GPU.

Prints the SHA-1 of the kernels' outputs on seeded inputs and their
CUDA-event medians at the shapes of the main path: the 2D headline
(256^2 modes, 65,536 uniform points, tol 1e-6, seed 42; planned and
unplanned, B2 2, 6 and 16, phi' on each axis), the 3D headline's
unbanded geometry (128^3 modes, 800,000 points; planned and unplanned,
B2 2 and 6, phi' on axis 0) and the 3D mats size (its first 200,000
points, planned). The hashes let two trees be compared bit for bit: run
the probe once with this tree and once with another checkout's package
first on PYTHONPATH.

--cycles  also prints the clock64 counters of tools/torch_banded_probe.py
          for the unbanded 3D spread (unplanned, B2 2).

Usage: python3 tools/torch_unbanded_probe.py [--cycles]
"""

import sys

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import binning, interp, spread
from tensorflow_nufft_tpu_torch.ops.planar_core import bin_for_plan
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
from torch_banded_probe import cuda_ms, sha


def cases(rank, grid, m):
    """(label, call) of every unbanded kernel at one layout."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    pts = rng.uniform(-np.pi, np.pi, (800_000 if rank == 3 else m, rank))
    pts = torch.from_numpy(pts[:m].astype(np.float32)).to(dev)
    plan = make_plan(PlanSpec("type_1", "forward", rank, grid, "complex64",
                              1e-6, 1))
    geom, binned = bin_for_plan(pts, plan)
    kw = binning.build_weight_payload(binned, geom, plan)
    coords = binning.build_coords_payload(binned)
    tb = binned.tile_bounds
    gen = torch.Generator(device=dev).manual_seed(52)
    tiles = torch.randn(geom.tiles + (2,) + geom.ext, generator=gen,
                        device=dev)
    values = {b2: binning.build_values_payload(torch.randn(
        (b2, m), generator=gen, device=dev), binned)
        for b2 in ((2, 6, 16) if rank == 2 else (2, 6))}
    out = [("spread planned B2 2", lambda: spread.spread_planned_cuda(
               values[2], tb, geom, plan, kw)),
           ("interp planned", lambda: interp.interp_planned_cuda(
               tiles, tb, geom, plan, kw))]
    if m < 800_000 and rank == 3:
        return out
    for b2, vals in values.items():
        out.append((f"spread unplanned B2 {b2}",
                    lambda v=vals: spread.spread_unplanned_cuda(
                        v, tb, geom, plan, coords)))
    out.append(("interp unplanned", lambda: interp.interp_unplanned_cuda(
        tiles, tb, geom, plan, coords)))
    for axis in range(rank if rank == 2 else 1):
        out.append((f"interp deriv axis {axis}",
                    lambda a=axis: interp.interp_deriv_cuda(
                        tiles, tb, geom, plan, coords, a)))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: the probe "
                         "needs an NVIDIA GPU")
    for tag, rank, grid, m in (("2d", 2, (256, 256), 65_536),
                               ("3d", 3, (128, 128, 128), 800_000),
                               ("3d_mats", 3, (128, 128, 128), 200_000)):
        for label, fn in cases(rank, grid, m):
            print(f"{tag} {label}: {sha(fn())} {cuda_ms(fn, reps=10):.4f} ms",
                  flush=True)
        torch.cuda.empty_cache()
    if "--cycles" in sys.argv:
        from torch_banded_probe import cycles
        cycles(dict(cases(3, (128, 128, 128), 800_000))[
            "spread unplanned B2 2"])


if __name__ == "__main__":
    main()
