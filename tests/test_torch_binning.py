"""Fold, binning and halo folds of the port against the JAX package.

The integer layout (padpos, invpos, chunk tiles, tile bounds) must be
bit-equal: an off-by-one there moves whole points between tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import xla_ops
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import torch_ops
from tests.torch_threads import one_torch_thread  # noqa: F401

FINE = (128, 192)


def _points(kind, m, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    if kind == "clustered":
        # Two tight clusters: most tiles empty, two tiles overfull.
        centers = np.array([[0.3, -2.0], [-1.1, 2.9]])
        pts = centers[rng.integers(0, 2, m)] + 0.05 * rng.standard_normal(
            (m, 2))
        return pts.astype(np.float32)
    if kind == "extended":
        return rng.uniform(-3 * np.pi, 3 * np.pi, (m, 2)).astype(np.float32)
    if kind == "edges":
        # Exactly +-pi, tile boundaries and zero.
        base = np.array([[-np.pi, np.pi], [0.0, 0.0], [np.pi, -np.pi],
                         [-np.pi / 2, np.pi / 3]], np.float32)
        return np.concatenate([base, rng.uniform(
            -np.pi, np.pi, (m - 4, 2)).astype(np.float32)])
    raise ValueError(kind)


@pytest.mark.parametrize("points_range,kind", [
    (0, "uniform"), (1, "extended"), (2, "extended"), (1, "edges"),
    (2, "uniform")])
def test_fold_split_matches_jax(points_range, kind):
    pts = _points(kind, 3000)
    if points_range == 2:
        pts = pts * 7.0          # far out: exercises the compensated wrap
    j_hi, j_lo = xla_ops.fold_and_rescale_split(
        jnp.asarray(pts), FINE, points_range)
    t_hi, t_lo = torch_ops.fold_and_rescale_split(
        torch.from_numpy(pts), FINE, points_range)
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    s64 = torch_ops.fold_and_rescale(
        torch.from_numpy(pts.astype(np.float64)), FINE,
        points_range).numpy()
    pair = t_hi.numpy().astype(np.float64) + t_lo.numpy()
    # Compare on the torus: a point at exactly +-pi may fold to either
    # end of [0, nf] in float32 and float64.
    nf = np.array(FINE, np.float64)
    diff = np.mod(pair - s64, nf)
    assert np.max(np.minimum(diff, nf - diff)) <= 1e-9


@pytest.mark.parametrize("points_range", (0, 1, 2))
def test_fold_f64_matches_jax(points_range):
    pts = _points("extended" if points_range else "uniform",
                  500).astype(np.float64) * (5 if points_range == 2 else 1)
    j = xla_ops.fold_and_rescale(jnp.asarray(pts), FINE, points_range)
    t_hi, t_lo = torch_ops.fold_and_rescale_split(
        torch.from_numpy(pts), FINE, points_range)
    np.testing.assert_allclose(t_hi.numpy(), np.asarray(j), rtol=0,
                               atol=1e-12)
    assert not t_lo.any()


@pytest.mark.parametrize("kind,m", [
    ("uniform", 2000), ("uniform", 1000), ("clustered", 2000),
    ("edges", 777), ("extended", 3001)])
def test_binned_points_bit_equal(kind, m):
    pts = _points(kind, m, seed=m)
    geom_j = jb.choose_geometry(FINE, 7, m)
    geom_t = tb.choose_geometry(FINE, 7, m)
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), FINE, 1)
    bj = jb.bin_points(pr, geom_j)
    bt = tb.bin_points(tuple(torch.from_numpy(np.array(x)) for x in pr),
                       geom_t)
    for field in ("padpos", "invpos", "tile_bounds"):
        got, want = getattr(bt, field).numpy(), np.asarray(getattr(bj, field))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=field)
    for d in range(2):
        np.testing.assert_array_equal(bt.chunk_tidx[d].numpy(),
                                      np.asarray(bj.chunk_tidx[d]))
    if kind == "clustered":
        counts = np.diff(bt.tile_bounds.numpy())
        assert (counts == 1).sum() >= geom_t.num_tiles - 4   # empty tiles


def test_binned_from_numpy_roundtrip():
    pts = _points("uniform", 900)
    geom = tb.choose_geometry(FINE, 7, 900)
    pr = tuple(torch.from_numpy(x) for x in (pts * 10, pts * 0))
    b = tb.bin_points(pr, geom)
    b2 = tb.binned_from_numpy(*(x.numpy() for x in b[:4]),
                              [c.numpy() for c in b.chunk_tidx],
                              b.tile_bounds.numpy())
    for x, y in zip(b[:4] + (b.tile_bounds,), b2[:4] + (b2.tile_bounds,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b2", (2, 6))
def test_overlap_add_and_extend_tiles_match_jax(b2):
    rng = np.random.default_rng(b2)
    geom = tb.choose_geometry(FINE, 7, 2000)
    tiles = rng.standard_normal(geom.tiles + (b2,) + geom.ext).astype(
        np.float32)
    fine = rng.standard_normal((b2,) + FINE).astype(np.float32)
    jgeom = jb.choose_geometry(FINE, 7, 2000)
    np.testing.assert_array_equal(
        tb.overlap_add(torch.from_numpy(tiles), geom).numpy(),
        np.asarray(jb.overlap_add(jnp.asarray(tiles), jgeom)))
    np.testing.assert_array_equal(
        tb.extend_tiles(torch.from_numpy(fine), geom).numpy(),
        np.asarray(jb.extend_tiles(jnp.asarray(fine), jgeom)))


def test_payloads_and_scatter_chunked_match_jax():
    pts = _points("uniform", 1500)
    m = pts.shape[0]
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((4, m)).astype(np.float32)
    jgeom = jb.choose_geometry(FINE, 7, m)
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), FINE, 1)
    bj = jb.bin_points(pr, jgeom)
    bt = tb.bin_points(tuple(torch.from_numpy(np.array(x)) for x in pr),
                       tb.choose_geometry(FINE, 7, m))
    vp_t = tb.build_values_payload(torch.from_numpy(vals), bt)
    vp_j = np.asarray(jb.build_values_payload(jnp.asarray(vals), bj,
                                              jgeom))[:4]
    np.testing.assert_array_equal(vp_t.numpy(), vp_j)
    cp_t = tb.build_coords_payload(bt)
    cp_j = np.asarray(jb.build_coords_payload(bj, jgeom))   # [NC, 8, C]
    cp_j = cp_j.transpose(1, 0, 2).reshape(8, -1)[:4]
    np.testing.assert_array_equal(cp_t.numpy(), cp_j)
    back_t = tb.scatter_chunked(vp_t, bt)
    back_j = np.asarray(jb.scatter_chunked(jnp.asarray(vp_j), bj))
    np.testing.assert_array_equal(back_t.numpy(), back_j)
    np.testing.assert_array_equal(back_t.numpy(), vals)


def test_slot_tiles_mark_unused_chunks():
    pts = _points("uniform", 2000)
    geom = tb.choose_geometry(FINE, 7, 2000)
    b = tb.bin_points(torch.from_numpy(pts * 10 + 50), geom)
    tiles = tb.slot_tiles(b.tile_bounds, geom)
    used = int(b.tile_bounds[-1]) * geom.chunk
    assert (tiles[used:] == -1).all() and (tiles[:used] >= 0).all()
    bounds = b.tile_bounds.numpy()
    for t in range(geom.num_tiles):
        owned = tiles[bounds[t] * geom.chunk:bounds[t + 1] * geom.chunk]
        assert (owned == t).all()
