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


def _bin_points_bincount(points_hi, geom, zorder):
    """``bin_points``' layout with the per-tile counts from
    ``torch.bincount``, the form the searched counts replace."""
    i32 = torch.int32
    m = points_hi.shape[0]
    tiles, chunk = geom.tiles, geom.chunk
    tid = None
    for d in range(geom.rank):
        td = torch.clamp(
            torch.floor_divide(points_hi[:, d], geom.tile[d]).to(i32),
            0, tiles[d] - 1)
        tid = td if tid is None else tid * tiles[d] + td
        if d == 0:
            tid0 = td
    key = tid
    if zorder:
        cell = tb.sort_cell_size(geom)
        zcells = geom.tile[0] // cell
        zc = torch.clamp(
            torch.floor_divide(points_hi[:, 0], cell).to(i32)
            - tid0 * zcells, 0, zcells - 1)
        key = tid * zcells + zc
    counts = torch.bincount(tid, minlength=geom.num_tiles).to(i32)
    rounds = torch.clamp((counts + chunk - 1) // chunk, min=1)
    chunk_starts = torch.cumsum(rounds, 0, dtype=i32) - rounds
    order = torch.argsort(key, stable=True)
    tid_sorted = tid[order].long()
    first = torch.cumsum(counts, 0, dtype=i32) - counts
    pos = torch.arange(m, dtype=i32)
    padpos = torch.empty(m, dtype=i32)
    padpos[order] = (chunk_starts[tid_sorted] * chunk
                     + (pos - first[tid_sorted]))
    chunk_tile = tb._chunk_tiles(chunk_starts, geom)
    chunk_tidx = []
    for d in range(geom.rank - 1, -1, -1):
        chunk_tidx.append((chunk_tile % tiles[d]).to(i32))
        chunk_tile = chunk_tile // tiles[d]
    tile_bounds = torch.cat(
        [chunk_starts, (chunk_starts[-1] + rounds[-1]).reshape(1)]).to(i32)
    invpos = torch.full((geom.num_slots,), m, dtype=i32)
    invpos[padpos.long()] = pos
    return padpos, invpos, tuple(reversed(chunk_tidx)), tile_bounds


_COUNT_FINE = {1: (512,), 2: (128, 192), 3: (64, 64, 128)}


@pytest.mark.parametrize("kind", ("clustered", "ends"))
@pytest.mark.parametrize("zorder", (False, True))
@pytest.mark.parametrize("rank", (1, 2, 3))
def test_bin_points_counts_match_bincount(rank, zorder, kind):
    fine = np.array(_COUNT_FINE[rank], np.float32)
    rng = np.random.default_rng(10 * rank + zorder)
    m = 2000
    if kind == "clustered":
        # Two tight clusters: most tiles empty, two tiles overfull.
        centers = rng.uniform(0, 1, (2, rank)) * fine
        pts = (centers[rng.integers(0, 2, m)]
               + 1.5 * rng.standard_normal((m, rank))) % fine
    else:
        # Uniform, then coordinates at and beyond the grid's ends and a
        # NaN, which the tile ids clamp into range.
        pts = rng.uniform(0, 1, (m, rank)) * fine
        pts[:6] = np.stack([np.zeros(rank), fine, fine + 5.0,
                            np.full(rank, -3.0), fine - 1e-3,
                            np.full(rank, np.nan)])
    pts = torch.from_numpy(pts.astype(np.float32))
    geom = tb.choose_geometry(_COUNT_FINE[rank], 7, m, banded=zorder)
    got = tb.bin_points((pts, torch.zeros_like(pts)), geom, zorder=zorder)
    padpos, invpos, chunk_tidx, tile_bounds = _bin_points_bincount(
        pts, geom, zorder)
    for field, want in (("padpos", padpos), ("invpos", invpos),
                        ("tile_bounds", tile_bounds)):
        assert getattr(got, field).dtype == torch.int32, field
        assert torch.equal(getattr(got, field), want), field
    for d in range(rank):
        assert torch.equal(got.chunk_tidx[d], chunk_tidx[d])
    if kind == "clustered" and geom.num_tiles > 4:
        counts = np.diff(got.tile_bounds.numpy())
        assert (counts == 1).sum() >= geom.num_tiles // 2   # empty tiles


def test_fold_constants_cached_on_device():
    info = torch_ops._const_tensor.cache_info
    pts = torch.from_numpy(_points("extended", 300))
    for dtype in (torch.float32, torch.float64):
        torch_ops.fold_and_rescale_split(pts.to(dtype), FINE, 1)
    before = info()
    for points_range in (0, 1, 2, 1):
        torch_ops.fold_and_rescale_split(pts, FINE, points_range)
    torch_ops.fold_and_rescale_split(pts.double(), FINE, 1)
    after = info()
    assert after.misses == before.misses
    assert after.hits > before.hits
    # A fine shape and a dtype not folded before each build constants.
    torch_ops.fold_and_rescale_split(pts, (136, 200), 1)
    assert info().misses > after.misses
    before = info()
    torch_ops._const(np.float32(4097.0), pts.to(torch.float16))
    assert info().misses == before.misses + 1
    # The cached constant is the value cast from its numpy dtype.
    c64 = np.array(FINE, np.float64) / (2.0 * np.pi)
    for value, like in ((c64, pts), (c64, pts.double()),
                        (c64.astype(np.float32), pts),
                        (np.float32(np.pi), pts.double())):
        got = torch_ops._const(value, like)
        assert got is torch_ops._const(value, like)
        assert got.dtype == like.dtype and got.device == like.device
        assert got.shape == np.shape(value)
        want = torch.from_numpy(np.asarray(value)).to(like.dtype)
        assert torch.equal(got, want)
    # A constant first built under inference mode can still be saved for
    # backward by a later call that records gradients.
    with torch.inference_mode():
        torch_ops.fold_and_rescale_split(pts, (144, 208), 1)
    p = pts.clone().requires_grad_()
    hi, _ = torch_ops.fold_and_rescale_split(p, (144, 208), 1)
    hi.sum().backward()
    assert p.grad is not None
