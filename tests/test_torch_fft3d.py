"""The port's FFT kernel (``kernels.fft3d``, ``csrc/fft3d.cu``) on the CPU.

The kernel runs only on the card. Here a numpy replay of its launch (the
blocks' line mapping of ``fft_launch``, the Stockham stages of
``radices`` with the twiddle table of ``twiddle_table``, in complex64
arithmetic) is held to numpy's float64 FFT and to the JAX package's
``fft_ops.fft_fine``, and the whole rank-3 type-1 and type-2 mode stages
built on it to the JAX package's Pallas passes (``pallas_dft``, interpret
mode). The launch plans are swept over every fine grid a rank-3 plan
makes. Tolerances: 2e-6 of the peak against float64 (a float32 FFT), 1e-4
of the peak against the Pallas passes, as ``test_torch_stages3d.py``.
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
    """One Stockham stage of the kernel (``stage<R>``) on [n, cols]."""
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


def replay_axis(x, dim, sign):
    """The kernel's launch along ``dim`` of the complex64 array ``x``,
    block by block, as ``fft_axis_kernel`` runs it."""
    n, inner, outer, cols, pitch, contig, blocks, smem = fft3d.fft_launch(
        x.shape, dim)
    assert pitch == cols + 1 and smem == 8 * (n + 2 * n * pitch)
    tw = fft3d.twiddle_table(n, sign)
    src, out = x.reshape(-1), np.empty(x.size, np.complex64)
    seen = np.zeros(x.size, np.int64)
    for blk in range(blocks):
        if contig:
            first = blk * cols
            base, valid = first * n, min(cols, outer - first)
            cells = base + np.arange(cols)[None, :] * n + \
                np.arange(n)[:, None]
        else:
            per_outer = -(-inner // cols)
            o, i0 = divmod(blk, per_outer)
            i0 *= cols
            base, valid = o * n * inner + i0, min(cols, inner - i0)
            cells = base + np.arange(n)[:, None] * inner + \
                np.arange(cols)[None, :]
        assert valid >= 1
        cells = cells[:, :valid]
        buf = src[cells]
        ns = 1
        for radix in fft3d.radices(n):
            buf = _stage(buf, tw, n, radix, ns, sign)
            ns *= radix
        out[cells] = buf
        seen[cells] += 1
    assert (seen == 1).all()      # every cell is one block's, once
    return out.reshape(x.shape)


def replay(x, dims, direction):
    """``fft3d_cuda``'s launches (last axis first) on ``x``."""
    sign = -1 if direction == "forward" else 1
    for d in sorted(dims, reverse=True):
        x = replay_axis(x, d, sign)
    return x


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def _grid(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (shape, dims): strided and contiguous axes, a tail block of fewer
# lines than a block takes, and the 3D headline's and large-tile cell's
# line lengths (256, 320) on one axis.
REPLAY_CASES = [((2, 6, 10, 12), (1, 2, 3)),
                ((1, 30, 4, 18), (1, 2, 3)),
                ((3, 20, 50, 8), (1, 2)),
                ((1, 256, 20), (1,)),
                ((3, 320), (1,)),
                ((2, 90, 3, 2), (1, 3))]


@pytest.mark.parametrize("shape,dims", REPLAY_CASES)
@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_fft_kernel_replay_matches_numpy(shape, dims, direction):
    x = _grid(shape, sum(shape))
    got = replay(x, dims, direction)
    x64 = x.astype(np.complex128)
    want = (np.fft.fftn(x64, axes=dims) if direction == "forward" else
            np.fft.ifftn(x64, axes=dims) * np.prod([shape[d] for d in dims]))
    _close(got, want, 2e-6)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_fft_kernel_replay_matches_jax_fft_fine(direction):
    x = _grid((2, 12, 20, 30), 5)
    want = fft_ops.fft_fine(jnp.asarray(x), 3, direction)
    _close(replay(x, (1, 2, 3), direction), want, 1e-5)
    # The plain version is the same function.
    _close(fft3d.fft_plain(torch.from_numpy(x), (1, 2, 3), direction),
           want, 1e-5)


def _fine_shapes():
    """Every fine grid of a rank-3 plan over a sweep of mode counts and
    tolerances (the widths and sigma the plan picks)."""
    shapes = set()
    for n in (2, 3, 8, 16, 24, 33, 50, 64, 96, 100, 128, 150, 200, 256,
              300):
        for tol in (1e-2, 1e-4, 1e-6):
            plan = make_plan(PlanSpec("type_1", "forward", 3, (n, n, n),
                                      "complex64", tol, 1))
            shapes.add(plan.fine_shape)
    return sorted(shapes)


def test_fft_launch_plans_take_every_fine_grid():
    for fine in _fine_shapes():
        for batch in (1, 3, 8):
            shape = (batch,) + fine
            for dim in (1, 2, 3):
                n = shape[dim]
                rad = fft3d.radices(n)
                assert int(np.prod(rad)) == n and set(rad) <= {2, 3, 4, 5}
                n_, inner, outer, cols, pitch, contig, blocks, smem = \
                    fft3d.fft_launch(shape, dim)
                assert (n_, inner * outer * n) == (n, int(np.prod(shape)))
                assert cols & (cols - 1) == 0
                assert 1 <= cols <= fft3d.FFT_THREADS
                assert smem <= _build.SMEM_LIMIT
                lines = outer if contig else inner
                per = blocks if contig else blocks // outer
                assert per * cols >= lines > (per - 1) * cols
                assert blocks < 2 ** 31 and n * inner < 2 ** 31


def test_fft_radices_refuse_other_primes():
    for n in (7, 14, 22, 1):
        with pytest.raises(ValueError, match="2\\^a 3\\^b 5\\^c"):
            fft3d.radices(n)


def test_fft3d_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fft3d.fft3d_cuda(torch.from_numpy(_grid((1, 4, 4, 4), 1)),
                         (1, 2, 3), "forward")


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_type1_stage_on_the_fft_kernel_matches_pallas(direction):
    """fold, the kernel's FFT (replayed), truncation and deconvolution
    against the Pallas passes A, B and C."""
    jp, tp, jgeom, tgeom = plans(direction)
    tiles = np.random.default_rng(3).standard_normal(
        tgeom.tiles + (2,) + tgeom.ext).astype(np.float32)
    want = pallas_dft.dft_truncate_deconvolve_tiled_pallas(
        jnp.asarray(tiles), jp, jgeom, 1)
    fine = mode3d.fold_plain(torch.from_numpy(tiles), tgeom, 1).numpy()
    spec = torch.from_numpy(replay(fine, (1, 2, 3), direction))
    got = mode3d.truncate_deconvolve_plain(spec, tp)
    _close(got.numpy(), want, 1e-4)
    # and the plain stage takes the same function
    _close(tfft.dft_truncate_deconvolve_tiled(torch.from_numpy(tiles), tp,
                                              tgeom, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("direction", ("forward", "backward"))
def test_type2_stage_on_the_fft_kernel_matches_pallas(direction):
    """Amplification and padding, the kernel's FFT (replayed) and the
    halo windows against the Pallas passes C, B and A of the dual
    chain."""
    jp, tp, jgeom, tgeom = plans(direction)
    modes = np.random.default_rng(4).standard_normal(
        (1,) + GRID + (2,)).astype(np.float32)
    want = pallas_dft.amplify_pad_dft_tiled_pallas(jnp.asarray(modes), jp,
                                                   jgeom)
    fine = mode3d.amplify_pad_plain(torch.from_numpy(modes), tp).numpy()
    got = mode3d.extend_plain(
        torch.from_numpy(replay(fine, (1, 2, 3), direction)), tgeom)
    _close(got.numpy(), want, 1e-4)
