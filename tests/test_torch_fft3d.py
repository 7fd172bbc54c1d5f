"""The port's FFT kernel (``kernels.fft3d``, ``csrc/fft3d.cu``) on the CPU.

The kernel runs only on the card. Here a numpy replay of its launches
(the lines and sides of ``axis_launches``, the four-step split of
``split_of``, the Stockham stages of ``radices`` with the twiddle table
of ``twiddle_table``, the modes-in load and modes-out store with the
deconvolution weights, in complex64 arithmetic) is held to numpy's
float64 FFT and to the JAX package's ``fft_ops.fft_fine``, and the whole
rank-3 type-1, type-2 and fused mode stages built on its pruned passes
to the JAX package's Pallas passes (``pallas_dft``, interpret mode) and
to float64. The launch plans are swept over every fine grid a rank-3
plan makes, cubic and with a long axis. Tolerances: 2e-6 of the peak
against float64 (a float32 FFT), 1e-4 of the peak against the Pallas
passes, as ``test_torch_stages3d.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.fft import fft_ops
from tensorflow_nufft_tpu.kernels import pallas_dft
from tensorflow_nufft_tpu_torch.fft import planar_fft as tfft
from tensorflow_nufft_tpu_torch.kernels import _build, fft3d, mode3d
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
from tests.test_torch_stages3d import GRID, plans
from tests.torch_threads import one_torch_thread  # noqa: F401


def _stage(src, tw, n, radix, ns, sign):
    """One Stockham stage of the kernel (``stage<R>``) on [n, lines]."""
    nr, span = n // radix, n // (ns * radix)
    j = np.arange(nr)
    k = j % ns
    v = [src[j + r * nr] * (tw[r * k * span][:, None] if r else 1)
         for r in range(radix)]
    if radix == 2:
        y = [v[0] + v[1], v[0] - v[1]]
    elif radix == 4:
        a, b, c, e = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        d = e * np.complex64(sign * 1j)
        y = [a + c, b + d, a - c, b - d]
    else:
        y = []
        for q in range(radix):
            acc = v[0]
            for r in range(1, radix):
                acc = acc + v[r] * tw[((r * q) % radix) * nr]
            y.append(acc)
    dst = np.empty_like(src)
    o = (j - k) * radix + k
    for r in range(radix):
        dst[o + r * ns] = y[r]
    return dst


def _mode_of(x, n, nf):
    """``mode_of`` of the kernel: the mode index at axis cell x, or -1."""
    return np.where(x < n - n // 2, x + n // 2,
                    np.where(x >= nf - n // 2, x - nf + n // 2, -1))


def _scale(v, wt):
    """__fmul_rn of both parts by the float32 weights ``wt``."""
    return (v.real * wt + 1j * (v.imag * wt)).astype(np.complex64)


def replay_launch(src, dst, launch, sign, weights=None, load_weights=False,
                  store_weights=0, wn=(1, 1, 1)):
    """One launch of ``fft_axis_kernel`` from the flat complex64 array
    ``src`` into ``dst``, every line at once, as the kernel's blocks run
    them; returns the flat indices of ``dst`` it wrote."""
    f = launch
    lines = f.outer * f.split * f.inner
    assert f.blocks * f.cols >= lines > (f.blocks - 1) * f.cols
    assert f.cols & (f.cols - 1) == 0 and f.pitch == f.cols + 1
    assert f.smem == 8 * (f.n + 2 * f.n * f.pitch) + 24 * f.cols
    assert f.smem <= _build.SMEM_LIMIT
    line = np.arange(lines)
    c, t = line % f.inner, line // f.inner
    r, o = t % f.split, t // f.split
    m = np.arange(f.n)[:, None]

    def cells(side):
        s = m * side.step + r * side.split_step
        idx = _mode_of(s, f.modes, f.axis_n) if side.modes else s
        assert idx.max() < side.len and s.max() < f.axis_n
        return idx, (o * side.len + idx) * f.inner + c

    idx, at = cells(f.src)
    buf = np.where(idx >= 0, src[np.where(idx >= 0, at, 0)],
                   np.complex64(0)).astype(np.complex64)
    if load_weights:
        w0, w1, w2 = weights
        wa = w0[(o // wn[1]) % wn[0]] * w1[o % wn[1]]
        buf = _scale(buf, wa * w2[np.maximum(idx, 0)])
    tw = fft3d.twiddle_table(f.n, sign)
    ns = 1
    for radix in fft3d.radices(f.n):
        buf = _stage(buf, tw, f.n, radix, ns, sign)
        ns *= radix
    if f.twiddle_store:
        buf = buf * fft3d.twiddle_table(f.axis_n, sign)[r * m]
    idx, at = cells(f.dst)
    if store_weights:
        w0, w1, w2 = weights
        wt = w0[np.maximum(idx, 0)] * w1[c // wn[2]]
        if store_weights == 3:
            wt = wt * w2[c % wn[2]]
        buf = _scale(buf, wt)
    keep = idx >= 0
    dst[at[keep]] = buf[keep]
    return at[keep]


def replay_axis(src, outer, n, inner, sign, modes=0, modes_in=False,
                modes_out=False, weights=None, load_weights=False,
                store_weights=0, wn=(1, 1, 1)):
    """``_run_axis``: the launches of ``axis_launches`` from the flat
    ``src``, through a dense scratch grid where the line is split (the
    weights with the first load and the last store), into a new flat
    array; every launch's store covers its output once."""
    launches = fft3d.axis_launches(outer, n, inner, modes, modes_in,
                                   modes_out)
    for i, launch in enumerate(launches):
        first, last = i == 0, i == len(launches) - 1
        out = np.full(outer * launch.dst.len * inner, np.nan, np.complex64)
        seen = replay_launch(src, out, launch, sign, weights,
                             load_weights and first,
                             store_weights if last else 0, wn)
        assert (np.bincount(seen, minlength=out.size) == 1).all()
        src = out
    return src


def replay(x, dims, direction):
    """``fft3d_cuda``'s launches (last axis first) on ``x``."""
    sign = -1 if direction == "forward" else 1
    for d in sorted(dims, reverse=True):
        x = replay_axis(x.reshape(-1), int(np.prod(x.shape[:d])),
                        x.shape[d], int(np.prod(x.shape[d + 1:])),
                        sign).reshape(x.shape)
    return x


def _weights(plan):
    return [plan.deconv_weights(d).astype(np.float32) for d in range(3)]


def replay_modes_to_fine(modes, plan):
    """``modes_to_fine_cuda`` on planar modes [B, *n, 2]."""
    batch = modes.shape[0]
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    sign = -1 if plan.spec.fft_direction == "forward" else 1
    x = modes.astype(np.float32).view(np.complex64).reshape(-1)
    x = replay_axis(x, batch * n0 * n1, f2, 1, sign, n2, modes_in=True,
                    weights=_weights(plan), load_weights=True,
                    wn=(n0, n1, n2))
    x = replay_axis(x, batch * n0, f1, f2, sign, n1, modes_in=True)
    x = replay_axis(x, batch, f0, f1 * f2, sign, n0, modes_in=True)
    return x.reshape((batch, f0, f1, f2))


def replay_fine_to_modes(fine, plan, axes=3):
    """``fine_to_modes_cuda`` on a complex64 grid [B, nf0, nf1, nf2]
    (``axes=2``: [B, nf0, nf1, n2])."""
    batch = fine.shape[0]
    (n0, n1, n2), (f0, f1, f2) = plan.grid_shape, plan.fine_shape
    sign = -1 if plan.spec.fft_direction == "forward" else 1
    x = fine.astype(np.complex64).reshape(-1)
    if axes == 3:
        x = replay_axis(x, batch * f0 * f1, f2, 1, sign, n2, modes_out=True)
    x = replay_axis(x, batch * f0, f1, n2, sign, n1, modes_out=True)
    x = replay_axis(x, batch, f0, n1 * n2, sign, n0, modes_out=True,
                    weights=_weights(plan), store_weights=axes,
                    wn=(n0, n1, n2))
    return x.view(np.float32).reshape((batch, n0, n1, n2, 2))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def _grid(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _fft64(x, dims, direction):
    x = x.astype(np.complex128)
    if direction == "forward":
        return np.fft.fftn(x, axes=dims)
    return np.fft.ifftn(x, axes=dims) * np.prod([x.shape[d] for d in dims])


# (shape, dims): strided and contiguous axes, a tail block of fewer
# lines than a block takes, the 3D headline's and large-tile cell's line
# lengths (256, 320) on one axis, and lines longer than shared memory
# (6000 and 8192: the four-step split) on the last, a middle and the
# first axis.
REPLAY_CASES = [((2, 6, 10, 12), (1, 2, 3)),
                ((1, 30, 4, 18), (1, 2, 3)),
                ((3, 20, 50, 8), (1, 2)),
                ((1, 256, 20), (1,)),
                ((3, 320), (1,)),
                ((2, 90, 3, 2), (1, 3)),
                ((1, 2, 3, 8192), (1, 2, 3)),
                ((1, 2, 6000, 3), (1, 2, 3)),
                ((1, 6000, 2, 2), (1, 2, 3))]


@pytest.mark.parametrize("shape,dims", REPLAY_CASES)
@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_fft_kernel_replay_matches_numpy(shape, dims, direction):
    x = _grid(shape, sum(shape))
    _close(replay(x, dims, direction), _fft64(x, dims, direction), 2e-6)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_fft_kernel_replay_matches_jax_fft_fine(direction):
    x = _grid((2, 12, 20, 30), 5)
    want = fft_ops.fft_fine(jnp.asarray(x), 3, direction)
    _close(replay(x, (1, 2, 3), direction), want, 1e-5)
    # The plain version is the same function.
    _close(fft3d.fft_plain(torch.from_numpy(x), (1, 2, 3), direction),
           want, 1e-5)


# Modes with a long fine axis (above 5,811 cells, 40 bytes a cell of one
# block's shared memory) on axis 2, 0 and 1.
LONG_MODES = [(8, 8, 4096), (4096, 8, 8), (16, 3000, 16)]


def _fine_shapes():
    """Every fine grid of a rank-3 plan over a sweep of mode counts and
    tolerances (the widths and sigma the plan picks): cubic, and with one
    long axis on each of axes 0, 1 and 2."""
    grids = [(n, n, n) for n in (2, 3, 8, 16, 24, 33, 50, 64, 96, 100, 128,
                                 150, 200, 256, 300)]
    for n in (2900, 3000, 4096, 6000, 10000):
        grids += [(n, 8, 8), (16, n, 16), (8, 8, n)]
    shapes = {}
    for grid in grids + LONG_MODES:
        for tol in (1e-2, 1e-4, 1e-6):
            plan = make_plan(PlanSpec("type_1", "forward", 3, grid,
                                      "complex64", tol, 1))
            shapes[plan.fine_shape] = plan.grid_shape
    return sorted(shapes.items())


def test_fft_launch_plans_take_every_fine_grid():
    fine_of = dict((m, f) for f, m in _fine_shapes())
    assert [fine_of[m] for m in LONG_MODES] == [
        (16, 16, 8192), (8192, 16, 16), (32, 6000, 32)]
    for fine, modes in _fine_shapes():
        for batch in (1, 3, 8):
            shape = (batch,) + fine
            for dim in (1, 2, 3):
                n, m = shape[dim], modes[dim - 1]
                outer = int(np.prod(shape[:dim]))
                inner = int(np.prod(shape[dim + 1:]))
                split = fft3d.split_of(n)
                assert (split is None) == (40 * n + 24 <= _build.SMEM_LIMIT)
                for kind in ((False, False), (True, False), (False, True)):
                    launches = fft3d.axis_launches(outer, n, inner, m, *kind)
                    assert len(launches) == (1 if split is None else 2)
                    for f in launches:
                        rad = fft3d.radices(f.n)
                        assert int(np.prod(rad)) == f.n
                        assert set(rad) <= {2, 3, 4, 5}
                        assert f.n * f.split == n == f.axis_n
                        assert (f.outer, f.inner) == (outer, inner)
                        assert 1 <= f.cols <= fft3d.FFT_THREADS
                        assert f.smem <= _build.SMEM_LIMIT
                        lines = outer * f.split * inner
                        assert f.blocks == -(-lines // f.cols) < 2 ** 31
                    assert launches[0].src.len == (m if kind[0] else n)
                    assert launches[-1].dst.len == (m if kind[1] else n)


def test_fft_radices_refuse_other_primes():
    for n in (7, 14, 22, 1):
        with pytest.raises(ValueError, match="2\\^a 3\\^b 5\\^c"):
            fft3d.radices(n)


def test_fft3d_cuda_refuses_cpu_tensors():
    _, tp, _, _ = plans("forward")
    with pytest.raises(ValueError, match="CUDA"):
        fft3d.fft3d_cuda(torch.from_numpy(_grid((1, 4, 4, 4), 1)),
                         (1, 2, 3), "forward")
    with pytest.raises(ValueError, match="CUDA"):
        fft3d.modes_to_fine_cuda(torch.zeros((1,) + GRID + (2,)), tp)
    with pytest.raises(ValueError, match="CUDA"):
        fft3d.fine_to_modes_cuda(torch.zeros(
            (1,) + tp.fine_shape, dtype=torch.complex64), tp)


def _modes64(modes, plan):
    """amplify_pad_plain and the FFT in float64."""
    fine = mode3d.amplify_pad_plain(torch.from_numpy(
        modes.astype(np.float64)), plan).numpy()
    return _fft64(fine, (1, 2, 3), plan.spec.fft_direction)


def _fine64(fine, plan, axes=3):
    """The FFT, truncate_deconvolve_plain in float64."""
    spec = _fft64(fine, (1, 2, 3)[:axes], plan.spec.fft_direction)
    return mode3d.truncate_deconvolve_plain(torch.from_numpy(spec), plan,
                                            axes).numpy()


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_type1_stage_on_the_fft_kernel_matches_pallas(direction):
    """fold, the kernel's pruned passes (replayed) with the truncation
    and deconvolution in the last store, against the Pallas passes A, B
    and C and against float64."""
    jp, tp, jgeom, tgeom = plans(direction)
    tiles = np.random.default_rng(3).standard_normal(
        tgeom.tiles + (2,) + tgeom.ext).astype(np.float32)
    want = pallas_dft.dft_truncate_deconvolve_tiled_pallas(
        jnp.asarray(tiles), jp, jgeom, 1)
    fine = mode3d.fold_plain(torch.from_numpy(tiles), tgeom, 1).numpy()
    got = replay_fine_to_modes(fine, tp)
    _close(got, want, 1e-4)
    _close(got, _fine64(fine, tp), 2e-6)
    # and the plain stage takes the same function
    _close(tfft.dft_truncate_deconvolve_tiled(torch.from_numpy(tiles), tp,
                                              tgeom, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_type2_stage_on_the_fft_kernel_matches_pallas(direction):
    """The kernel's pruned passes (replayed) with the amplification and
    padding in the first load, and the halo windows, against the Pallas
    passes C, B and A of the dual chain and against float64."""
    jp, tp, jgeom, tgeom = plans(direction)
    modes = np.random.default_rng(4).standard_normal(
        (1,) + GRID + (2,)).astype(np.float32)
    want = pallas_dft.amplify_pad_dft_tiled_pallas(jnp.asarray(modes), jp,
                                                   jgeom)
    fine = replay_modes_to_fine(modes, tp)
    _close(fine, _modes64(modes, tp), 2e-6)
    got = mode3d.extend_plain(torch.from_numpy(fine), tgeom)
    _close(got.numpy(), want, 1e-4)


def test_fused_stage_on_the_fft_kernel_matches_pallas():
    """The fused route's two-axis fold and the kernel's pruned passes of
    axes 1 and 0 (replayed, the weights of axes 0 and 1 in the last
    store) against the Pallas passes B and C and against float64."""
    jp, tp, jgeom, tgeom = plans("forward")
    y = np.random.default_rng(5).standard_normal(
        tgeom.tiles[:2] + (2,) + tgeom.ext[:2] + (GRID[2],)).astype(
            np.float32)
    want = pallas_dft._run_passes_bc(jnp.asarray(y), jp, jgeom, 1)
    fine = mode3d.fold_plain(torch.from_numpy(y), tgeom, 1, axes=2).numpy()
    got = replay_fine_to_modes(fine, tp, axes=2)
    _close(got, want, 1e-4)
    _close(got, _fine64(fine, tp, axes=2), 2e-6)
    _close(tfft.dft_truncate_deconvolve_fused(torch.from_numpy(y), tp, tgeom,
                                              1).numpy(), want, 1e-4)


@pytest.mark.parametrize("grid", LONG_MODES[:2])
@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_pruned_passes_take_long_lines(grid, direction):
    """Both stages at modes with a fine axis longer than shared memory
    (the split on the pruned end: axis 2's modes-in load, axis 0's
    modes-out store) against float64."""
    plan = make_plan(PlanSpec("type_1", direction, 3, grid, "complex64",
                              1e-6, 1))
    assert any(fft3d.split_of(n) for n in plan.fine_shape)
    modes = np.random.default_rng(6).standard_normal(
        (1,) + grid + (2,)).astype(np.float32)
    _close(replay_modes_to_fine(modes, plan), _modes64(modes, plan), 2e-6)
    fine = _grid((1,) + plan.fine_shape, 7)
    _close(replay_fine_to_modes(fine, plan), _fine64(fine, plan), 2e-6)
