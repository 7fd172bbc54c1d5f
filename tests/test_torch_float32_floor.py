"""The port's float32 floor against the JAX package's (ROADMAP fault 5).

The 1D type-2 and the planar type-3 miss tol in float32 at their
headline sizes, on the card and in the port's float32 plain pipeline.
These tests hold the port's CPU path to the JAX package's float32 path
on the same inputs at small sizes (``tests/torch_float32_floor.py`` has
the cases and runs the headline sizes).

Tolerance: the port may lose at most a quarter more than the JAX
package, ``err_port <= 1.25 * err_jax + 1e-8``, against the float64
transform and against the exact NUDFT alike: its tile-origin kernel
argument and summation order differ from the XLA path's in the last
bits, but a lost digit (10x) fails.
"""

from tests.torch_float32_floor import SIZES, type2_1d, type3_2d
from tests.torch_threads import one_torch_thread  # noqa: F401


def _hold(port, jax_, label):
    for what, p, j in zip(("float64 transform", "exact NUDFT"), port, jax_):
        assert p <= 1.25 * j + 1e-8, (
            f"{label}: the port's float32 error against the {what} "
            f"{p:.4e} exceeds 1.25x the JAX package's {j:.4e}")


def test_type2_1d_floor_matches_jax():
    _hold(*type2_1d(*SIZES["small"]["type2_1d"]), "1D type-2")


def test_type3_2d_floor_matches_jax():
    _hold(*type3_2d(*SIZES["small"]["type3_2d"]), "2D type-3")
