"""The port's rank-1 (1D) planar NUFFT against the JAX package.

Geometry: 96 modes -> fine 192 -> 3 tiles of 64, ext 72 (pad 4), so the
halos wrap; M = 2000 points in chunks of 512. On the same numpy-seeded
inputs:

- the fold words and ``BinnedPoints`` bit-equal, the planned windows
  equal to the JAX dense kernel matrices to 1e-7 of the peak;
- the plain spread and interp (the rank-1 ``v * w0`` and ``F * w0``)
  against the Pallas kernels' rank-1 branches in interpret mode
  (``spread_pallas_tiles``, ``interp_pallas_tiled``: mats and coords,
  B2 = 2 and 6, ``deriv_axis=0``) to 1e-5 of the peak;
- ``planar.nufft`` against ``tfft.planar.nufft`` to 1e-5 and against the
  float64 ``nudft`` at the JAX tests' gate, 1e-3;
- ``PlannedNufft`` at the JAX plan levels "mats", "binned" (budgets
  lowered) and "none" (float64), with its slot surface and ``normal``,
  against the JAX plan (Pallas in interpret mode);
- source and points gradients against ``jax.vjp`` and ``gradcheck`` in
  float64; the spread-only ops and their gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.kernels import binning as jb
from tensorflow_nufft_tpu.kernels import (pallas_interp, pallas_spread,
                                          xla_ops)
from tensorflow_nufft_tpu.plan import plan as jplan
from tensorflow_nufft_tpu_torch.kernels import binning as tb
from tensorflow_nufft_tpu_torch.kernels import (dispatch, interp, spread,
                                                torch_ops)
from tensorflow_nufft_tpu_torch.plan import plan as tplan
from tests.torch_threads import one_torch_thread  # noqa: F401

GRID = (96,)
FINE = (192,)
M = 2000
RTOL = 1e-5
ORACLE_TOL = 1e-3
PALLAS = tfft.Options(backend="pallas")
_jax_bin_points = jax.jit(jb.bin_points, static_argnums=1)


def _points(m, seed, dtype=np.float32, kind="uniform"):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        # Two tight clusters: one tile empty, one overfull.
        centers = np.array([0.4, -2.6])
        pts = centers[rng.integers(0, 2, m)] + 0.05 * rng.standard_normal(m)
        return pts[:, None].astype(dtype)
    return rng.uniform(-np.pi, np.pi, (m, 1)).astype(dtype)


def _data(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _fields(geom):
    return (geom.fine_shape, geom.tile, geom.pad, geom.chunk,
            geom.num_chunks)


def _relerr(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@functools.lru_cache(maxsize=None)
def layout(tol):
    """One binned point set, as both packages see it."""
    kw = dict(transform_type="type_1", fft_direction="forward", rank=1,
              grid_shape=GRID, dtype_name="complex64", tol=tol,
              points_range=1)
    jp = jplan.make_plan(jplan.PlanSpec(**kw))
    tp = tplan.make_plan(tplan.PlanSpec(**kw))
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(_points(M, 7)),
                                        jp.fine_shape, 1)
    jgeom = jb.choose_geometry(jp.fine_shape, jp.width, M)
    jbinned = _jax_bin_points(pr, jgeom)
    tgeom = tb.choose_geometry(tp.fine_shape, tp.width, M)
    assert _fields(tgeom) == _fields(jgeom)
    assert tgeom.tiles == (3,) and tgeom.ext == (72,)
    tbinned = tb.binned_from_numpy(
        *(np.asarray(x) for x in jbinned[:4]),
        [np.asarray(c) for c in jbinned.chunk_tidx],
        np.asarray(jbinned.tile_bounds))
    return dict(jp=jp, tp=tp, pr=pr, jgeom=jgeom, jbinned=jbinned,
                mats=jb.build_kernel_matrix_payload(jbinned, jgeom, jp),
                tgeom=tgeom, tbinned=tbinned,
                kw=tb.build_weight_payload(tbinned, tgeom, tp))


def test_plan_statics_match_jax_1d():
    for tol in (1e-3, 1e-6, 1e-9):
        kw = dict(transform_type="type_2", fft_direction="forward", rank=1,
                  grid_shape=(2 ** 20,), dtype_name="complex64", tol=tol,
                  points_range=1)
        jp = jplan.make_plan(jplan.PlanSpec(**kw))
        tp = tplan.make_plan(tplan.PlanSpec(**kw))
        assert (tp.width, tp.beta, tp.sigma, tp.fine_shape) == \
            (jp.width, jp.beta, jp.sigma, jp.fine_shape)
        np.testing.assert_array_equal(tp.deconv_weights(0),
                                      jp.deconv_weights(0))


@pytest.mark.parametrize("points_range,kind", [
    (1, "uniform"), (2, "uniform"), (1, "clustered")])
def test_fold_and_binning_bit_equal_1d(points_range, kind):
    pts = _points(M, 3, kind=kind)
    if points_range == 2:
        pts = pts * 7.0          # far out: exercises the compensated wrap
    j_pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), FINE,
                                          points_range)
    t_pr = torch_ops.fold_and_rescale_split(torch.from_numpy(pts), FINE,
                                            points_range)
    for t, j in zip(t_pr, j_pr):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    geom = tb.choose_geometry(FINE, 7, M)
    jgeom = jb.choose_geometry(FINE, 7, M)
    assert _fields(geom) == _fields(jgeom)
    bj = _jax_bin_points(j_pr, jgeom)
    bt = tb.bin_points(t_pr, geom)
    for field in ("padpos", "invpos", "tile_bounds"):
        got, want = getattr(bt, field).numpy(), np.asarray(getattr(bj, field))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_array_equal(bt.chunk_tidx[0].numpy(),
                                  np.asarray(bj.chunk_tidx[0]))


@pytest.mark.parametrize("tol", (1e-6, 1e-3))
def test_weight_payload_is_the_dense_mats_1d(tol):
    """The planned windows, scattered into dense [E0, C] matrices, are the
    JAX package's precomputed kernel matrices."""
    lay = layout(tol)
    geom, kw, mats = lay["tgeom"], lay["kw"], np.asarray(lay["mats"])
    nc, c, w, e = geom.num_chunks, geom.chunk, lay["tp"].width, geom.ext[0]
    used = int(lay["tbinned"].tile_bounds[-1])
    starts = kw.starts[0].numpy().reshape(nc, c)
    weights = kw.weights[0].numpy().reshape(nc, c, w)
    dense = np.zeros_like(mats)
    for k in range(used):
        for j in range(w):
            rows = starts[k] + j
            ok = (rows >= 0) & (rows < e)
            dense[k, rows[ok], np.nonzero(ok)[0]] = weights[k, ok, j]
    peak = np.max(np.abs(mats))
    assert np.max(np.abs(dense[:used] - mats[:used])) <= 1e-7 * peak


@pytest.mark.parametrize("b2,source", [
    (2, "planned"), (2, "unplanned"), (6, "planned"), (6, "unplanned")])
def test_spread_plain_matches_pallas_1d(b2, source):
    lay = layout(1e-6)
    vals = _data(b2, (b2, M))
    want, _ = pallas_spread.spread_pallas_tiles(
        jnp.asarray(vals), lay["pr"], lay["jp"], binned=lay["jbinned"],
        mats=lay["mats"] if source == "planned" else None,
        geom=lay["jgeom"])
    tbinned, geom = lay["tbinned"], lay["tgeom"]
    values = torch.from_numpy(vals)
    kw = lay["kw"] if source == "planned" else None
    before = (spread.spread_planned_cuda.launches,
              spread.spread_unplanned_cuda.launches)
    got = dispatch.spread_tiled(values, tbinned, geom, lay["tp"], kw=kw)
    assert (spread.spread_planned_cuda.launches,
            spread.spread_unplanned_cuda.launches) == before
    assert got.shape == (3, b2, 72)
    assert _relerr(got, want) <= RTOL


@pytest.mark.parametrize("b2,source,deriv_axis", [
    (2, "planned", None), (2, "unplanned", None), (6, "planned", None),
    (6, "unplanned", None), (2, "unplanned", 0)])
def test_interp_plain_matches_pallas_1d(b2, source, deriv_axis):
    lay = layout(1e-6)
    geom, tbinned = lay["tgeom"], lay["tbinned"]
    tiles = _data(10 + b2, geom.tiles + (b2,) + geom.ext)
    want = np.asarray(pallas_interp.interp_pallas_tiled(
        jnp.asarray(tiles), lay["pr"], lay["jp"], lay["jgeom"],
        binned=lay["jbinned"],
        mats=lay["mats"] if source == "planned" else None,
        chunk_order=True, deriv_axis=deriv_axis))        # [B2, NC * C]
    weights = (dict(kw=lay["kw"]) if source == "planned" else
               dict(coords=tb.build_coords_payload(tbinned)))
    got = interp.interp_tiles_plain(
        torch.from_numpy(tiles), tbinned.tile_bounds, geom, lay["tp"],
        deriv_axis=deriv_axis, **weights)                # [NC, B2, C]
    used = int(tbinned.tile_bounds[-1]) * geom.chunk
    got = got.transpose(0, 1).reshape(b2, -1)
    assert _relerr(got[:, :used], want[:, :used]) <= RTOL
    assert not got[:, used:].any()


@functools.lru_cache(maxsize=None)
def case(transform_type, direction, dtype):
    """Seeded points and source of one transform, and the JAX package's
    result on them."""
    pts = _points(M, 1, dtype)
    src = _data(2, ((M,) if transform_type == "type_1" else GRID) + (2,),
                dtype)
    want = np.asarray(tfft.planar.nufft(
        src, pts, grid_shape=GRID if transform_type == "type_1" else None,
        transform_type=transform_type, fft_direction=direction))
    return pts, src, want


@pytest.mark.parametrize("transform_type,direction,dtype", [
    ("type_1", "forward", np.float32), ("type_1", "backward", np.float64),
    ("type_2", "forward", np.float64), ("type_2", "backward", np.float32)])
def test_nufft_matches_jax_1d(transform_type, direction, dtype):
    pts, src, want = case(transform_type, direction, dtype)
    got = tnt.planar.nufft(
        torch.from_numpy(src), torch.from_numpy(pts),
        grid_shape=GRID if transform_type == "type_1" else None,
        transform_type=transform_type, fft_direction=direction)
    assert got.dtype == torch.from_numpy(src).dtype
    assert _relerr(got, want) <= RTOL


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_nufft_matches_nudft_1d(transform_type):
    pts, src = _points(400, 6), _data(
        7, ((400,) if transform_type == "type_1" else GRID) + (2,))
    kw = dict(grid_shape=GRID if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    got = tnt.planar.nufft(torch.from_numpy(src), torch.from_numpy(pts),
                           **kw)
    oracle = tnt.planar.nudft(src.astype(np.float64),
                              pts.astype(np.float64), device="cpu", **kw)
    assert _relerr(got, oracle) <= ORACLE_TOL


def _level_plans(level):
    """(JAX type-2 plan, port type-2 plan, points) at a JAX plan level:
    "binned" with both packages' dense-matrix budgets lowered, "none" on
    float64 points."""
    dtype = np.float64 if level == "none" else np.float32
    pts = _points(M, 11, dtype)
    budgets = pallas_spread.MATS_BYTES_BUDGET, tb.MATS_BYTES_BUDGET
    if level == "binned":
        pallas_spread.MATS_BYTES_BUDGET = tb.MATS_BYTES_BUDGET = 0
    try:
        jop = tfft.planar.PlannedNufft(
            pts, GRID, transform_type="type_2",
            options=PALLAS if level != "none" else None)
        top = tnt.PlannedNufft(pts, GRID, transform_type="type_2",
                               device="cpu")
    finally:
        pallas_spread.MATS_BYTES_BUDGET, tb.MATS_BYTES_BUDGET = budgets
    assert top.level == level
    assert jop._level == level or (level == "none" and not jop._planned)
    assert top.band_info is None
    return jop, top, pts


@functools.lru_cache(maxsize=None)
def level_case(level):
    """The JAX plan's results on one set of inputs: the apply and its
    source vjp, the adjoint apply, the slot surface and ``normal``."""
    jop, top, pts = _level_plans(level)
    dtype = pts.dtype
    x = _data(20, (2,) + GRID + (2,), dtype)
    c = _data(21, (2, M, 2), dtype)
    ct = _data(22, (2, M, 2), dtype)
    w = np.random.default_rng(23).uniform(0.5, 1.5, M).astype(dtype)
    out, vjp = jax.vjp(jop, jnp.asarray(x))
    slots_c = jop.adjoint().to_slots(c) if level != "none" else c
    want = dict(
        apply=np.asarray(out), grad=np.asarray(vjp(jnp.asarray(ct))[0]),
        adjoint=np.asarray(jop.adjoint()(c)),
        normal=np.asarray(jop.normal(x, jop.slot_weights(w))),
        apply_to_slots=np.asarray(jop.apply_to_slots(x)),
        apply_from_slots=np.asarray(
            jop.adjoint().apply_from_slots(np.asarray(slots_c))),
        to_slots=np.asarray(slots_c),
        num_slots=jop.num_slots,
        slot_mask=np.asarray(jop.slot_mask) if level != "none" else None)
    return top, x, c, ct, w, want


@pytest.mark.parametrize("level", ("mats", "binned", "none"))
def test_planned_levels_and_slot_surface_match_jax_1d(level):
    top, x, c, ct, w, want = level_case(level)
    adj = top.adjoint()
    assert top.num_slots == want["num_slots"]
    if want["slot_mask"] is not None:
        np.testing.assert_array_equal(top.slot_mask.numpy(),
                                      want["slot_mask"])
    if level == "mats":
        assert top.weights.weights.shape[0] == 1
    src = torch.from_numpy(x.copy()).requires_grad_()
    out = top(src)
    out.backward(torch.from_numpy(ct))
    xt, ctt = torch.from_numpy(x), torch.from_numpy(c)
    slots_c = top.adjoint().to_slots(ctt)
    got = dict(
        apply=out, grad=src.grad, adjoint=adj(ctt),
        normal=top.normal(xt, top.slot_weights(w)),
        apply_to_slots=top.apply_to_slots(xt),
        apply_from_slots=adj.apply_from_slots(slots_c), to_slots=slots_c)
    for name, value in got.items():
        assert _relerr(value, want[name]) <= RTOL, name
    # The planned apply is the unplanned transform.
    unplanned = tnt.planar.nufft(xt, top.points, tol=top.tol)
    assert _relerr(top(xt), unplanned.detach()) <= RTOL


@functools.lru_cache(maxsize=None)
def grad_case(transform_type, direction):
    """Inputs at batch 3 (B2 = 6) and the JAX vjp (its XLA path on the
    CPU; the Pallas kernels' rank-1 branches are held above) and that of
    the float64 nudft."""
    pts = _points(400, 30)
    shape = (3,) + ((400,) if transform_type == "type_1" else GRID) + (2,)
    out_shape = (3,) + (GRID if transform_type == "type_1" else (400,)) \
        + (2,)
    src, ct = _data(31, shape), _data(32, out_shape)
    kw = dict(grid_shape=GRID if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction=direction)
    out, vjp = jax.vjp(
        lambda s, p: tfft.planar.nufft(s, p, **kw), src, pts)
    _, vjp64 = jax.vjp(lambda s, p: tfft.planar.nudft(s, p, **kw),
                       src.astype(np.float64), pts.astype(np.float64))
    return (pts, src, ct, kw, np.asarray(out),
            [np.asarray(g) for g in vjp(ct)],
            [np.asarray(g) for g in vjp64(ct.astype(np.float64))])


@pytest.mark.parametrize("transform_type,direction", [
    ("type_2", "forward"), ("type_1", "backward")])
def test_nufft_grads_match_jax_1d(transform_type, direction):
    pts, src, ct, kw, want, grads, oracle = grad_case(transform_type,
                                                      direction)
    s = torch.from_numpy(src).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    out = tnt.planar.nufft(s, p, **kw)
    out.backward(torch.from_numpy(ct))
    assert _relerr(out, want) <= RTOL
    for got, ref, ora in zip((s.grad, p.grad), grads, oracle):
        assert _relerr(got, ref) <= RTOL
        assert _relerr(got, ora) <= ORACLE_TOL


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_gradcheck_float64_1d(transform_type):
    """Central differences (fast mode) against the analytic source and
    points gradients at tol 1e-12; atol as in ``test_torch_grad.py``."""
    rng = np.random.default_rng(40)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (10, 1)))
    grid = (16,)
    shape = (2,) + ((10,) if transform_type == "type_1" else grid) + (2,)
    src = torch.from_numpy(rng.standard_normal(shape))
    kw = dict(grid_shape=grid if transform_type == "type_1" else None,
              transform_type=transform_type, fft_direction="backward")
    assert torch.autograd.gradcheck(
        lambda s, p: tnt.planar.nufft(s, p, tol=1e-12, **kw),
        (src.requires_grad_(), pts.requires_grad_()), atol=1e-6, rtol=1e-5,
        fast_mode=True)


@functools.lru_cache(maxsize=None)
def spread_only_case(transform_type):
    """A spread-only op's inputs and ``jax.vjp`` of the JAX op on the
    fine grid FINE (its analytic custom VJP)."""
    pts = _points(500, 50)
    shape = (2, 500, 2) if transform_type == "type_1" else (2,) + FINE + (2,)
    src = _data(51, shape)
    fn = (functools.partial(tfft.planar.spread, grid_shape=FINE)
          if transform_type == "type_1" else tfft.planar.interp)
    out, vjp = jax.vjp(fn, src, pts)
    ct = _data(52, out.shape)
    return pts, src, ct, np.asarray(out), [np.asarray(g) for g in vjp(ct)]


@pytest.mark.parametrize("transform_type", ("type_1", "type_2"))
def test_spread_only_ops_and_grads_match_jax_1d(transform_type):
    pts, src, ct, want, grads = spread_only_case(transform_type)
    s = torch.from_numpy(src).requires_grad_()
    p = torch.from_numpy(pts).requires_grad_()
    fn = (functools.partial(tnt.planar.spread, grid_shape=FINE)
          if transform_type == "type_1" else tnt.planar.interp)
    before = interp.interp_deriv_cuda.launches
    out = fn(s, p)
    assert _relerr(out, want) <= RTOL
    out.backward(torch.from_numpy(ct))
    assert interp.interp_deriv_cuda.launches == before
    assert _relerr(s.grad, grads[0]) <= RTOL
    assert _relerr(p.grad, grads[1]) <= RTOL


def test_spread_only_gradcheck_float64_1d():
    rng = np.random.default_rng(60)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (10, 1)))
    grid = torch.from_numpy(rng.standard_normal((2, 32, 2)))
    assert torch.autograd.gradcheck(
        lambda g, p: tnt.planar.interp(g, p, tol=1e-12),
        (grid.requires_grad_(), pts.requires_grad_()), atol=1e-6, rtol=1e-5,
        fast_mode=True)


def test_ranks_outside_one_to_three_raise():
    pts4 = torch.zeros(10, 4)
    for call in (
            lambda: tnt.planar.nufft(torch.zeros(10, 2), pts4,
                                     grid_shape=(8,) * 4,
                                     transform_type="type_1"),
            lambda: tnt.planar.nufft(torch.zeros((8,) * 4 + (2,)), pts4),
            lambda: tnt.planar.nudft(torch.zeros((8,) * 4 + (2,)), pts4),
            lambda: tnt.planar.interp(torch.zeros((8,) * 4 + (2,)), pts4),
            lambda: tnt.planar.spread(torch.zeros(10, 2), pts4, (8,) * 4),
            lambda: tnt.PlannedNufft(pts4, (8,) * 4, device="cpu")):
        with pytest.raises(ValueError, match="rank must be 1, 2 or 3"):
            call()
