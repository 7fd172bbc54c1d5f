"""The port's profiling module (``utils/profiling.py``) against the JAX
package's: the stage spans of a transform carry the JAX package's scope
names (the same set as in the JAX jaxpr of the same call), and the
verbosity log and trace helpers behave as the JAX ones."""

import re

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu_torch.utils import profiling as prof
from tests.torch_threads import one_torch_thread  # noqa: F401

SPAN = re.compile(r"\bnufft3?\.[a-z_0-9]+")


def _inputs(dtype=np.float32):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-np.pi, np.pi, (32, 2)).astype(dtype)
    vals = (rng.standard_normal(32)
            + 1j * rng.standard_normal(32)).astype(np.complex128)
    modes = (rng.standard_normal((8, 8))
             + 1j * rng.standard_normal((8, 8))).astype(np.complex128)
    return pts, vals, modes


def planar(z):
    """complex -> float32 [..., 2]."""
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def port_spans(fn):
    """The stage span names a call of ``fn`` records."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    return {e.name for e in p.events() if SPAN.fullmatch(e.name)}


def jax_spans(fn, *args):
    """The scope names in the lowered JAX call."""
    text = jax.jit(fn).lower(*args).as_text(debug_info=True)
    return set(SPAN.findall(text))


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_planar_spans_are_the_jax_scopes(transform_type):
    pts, vals, modes = _inputs()
    if transform_type == "type_1":
        src, grid = planar(vals), (8, 8)
    else:
        src, grid = planar(modes), None
    kw = dict(grid_shape=grid, transform_type=transform_type)
    got = port_spans(lambda: tnt.planar.nufft(
        torch.from_numpy(src), torch.from_numpy(pts), device="cpu", **kw))
    want = jax_spans(lambda s, p: tfft.planar.nufft(s, p, **kw), src, pts)
    assert got == want
    expect = ({"nufft.spread", "nufft.mode_dft_deconvolve"}
              if transform_type == "type_1"
              else {"nufft.amplify_dft", "nufft.interp"})
    assert got == {"nufft.fold_rescale"} | expect


def test_xla_route_spans_are_the_jax_complex_scopes():
    pts, vals, _ = _inputs(np.float64)
    kw = dict(grid_shape=(8, 8), transform_type="type_1")
    got = port_spans(lambda: tnt.nufft(
        torch.from_numpy(vals), torch.from_numpy(pts), device="cpu",
        options=tnt.Options(backend="xla"), **kw))
    want = jax_spans(lambda s, p: tfft.nufft(s, p, **kw), vals, pts)
    assert got == want == {"nufft.fold_rescale", "nufft.spread",
                           "nufft.fft", "nufft.deconvolve"}


@pytest.mark.parametrize("planar_api", [False, True])
def test_type3_spans(planar_api):
    rng = np.random.default_rng(1)
    x = rng.uniform(-3, 7, (40, 2)).astype(np.float32)
    t = rng.uniform(-20, 50, (30, 2)).astype(np.float32)
    c = (rng.standard_normal((1, 40))
         + 1j * rng.standard_normal((1, 40))).astype(np.complex64)
    if planar_api:
        op = tnt.planar.Type3Plan(torch.from_numpy(x), torch.from_numpy(t))
        src = torch.from_numpy(planar(c))
    else:
        op = tnt.Type3Plan(torch.from_numpy(x), torch.from_numpy(t))
        src = torch.from_numpy(c)
    names = port_spans(lambda: op(src))
    assert {"nufft3.spread", "nufft3.inner_t2"} <= names


def test_log_gated_by_level(capsys):
    old = prof.verbosity()
    try:
        prof.set_verbosity(0)
        prof.log(1, "hidden")
        prof.set_verbosity(1)
        prof.log(1, "shown")
        prof.log(2, "hidden2")
    finally:
        prof.set_verbosity(old)
    err = capsys.readouterr().err
    assert "[tfft] shown" in err
    assert "hidden" not in err


def test_plan_summary_logged_once_as_jax(capsys):
    pts = np.random.default_rng(0).uniform(-1, 1, (10, 2)).astype(
        np.float32)
    z = np.ones(10, np.complex64)
    kw = dict(grid_shape=(8, 8), transform_type="type_1")
    tnt.nufft(z, pts, options=tnt.Options(verbosity=1), device="cpu", **kw)
    tnt.nufft(z, pts, device="cpu", **kw)
    port = capsys.readouterr().err
    assert port.count("[tfft] plan:") == 1
    assert "width=7" in port and "fine=(16, 16)" in port
    tfft.nufft(z, pts, options=tfft.Options(verbosity=1), **kw)
    assert capsys.readouterr().err == port


def test_trace_writes_file(tmp_path):
    with prof.trace(str(tmp_path)):
        with prof.annotate("host-span"):
            torch.arange(8.0) * 2
    files = list(tmp_path.rglob("*.json"))
    assert files and "host-span" in files[0].read_text()
    with pytest.raises(RuntimeError):
        prof.stop_trace()


def test_annotate_and_scope_without_profiler():
    with prof.annotate("host-span"), prof.scope("stage"):
        y = torch.arange(4.0) * 2
    assert y.tolist() == [0, 2, 4, 6]
