"""CPU tests of the benchmark: small configurations of each cell."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "tfnufft_3d_128_800k": {
        "modes": [12, 12, 12], "points": {"kind": "uniform", "count": 3000},
        "tol": 1e-6},
    "rrsg_brain_radial_12coil": {
        "modes": [24, 24], "coils": 3,
        "points": {"kind": "radial", "spokes": 8, "samples": 48},
        "cg_iterations": 4, "tol": 1e-6},
}


def small_run(cell, seed=2147483651, trace=False, seconds=0.3):
    """``run_cell`` of ``cell`` on the CPU at a small size."""
    from benchmark import run, spec
    bench = spec.load()
    w = spec.workload(bench, cell)
    traffic = dict(spec.traffic(w["traffic"]), check_size=64)
    return run.run_cell(cell, seed, seconds, trace, "cpu",
                        config=SMALL[w["config"]], traffic=traffic)
