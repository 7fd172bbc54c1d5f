"""The port's hand-written proto codec of ``Options`` against the JAX
package's protobuf messages: equal bytes, and decoding of the JAX bytes,
the JAX messages, unknown fields and truncated input."""

import itertools
import struct

import pytest

import tensorflow_nufft_tpu as tfft
import tensorflow_nufft_tpu_torch as tnt
from tensorflow_nufft_tpu.proto import nufft_options_pb2

BACKENDS = ("auto", "xla", "pallas", "native")
UPSAMPLING = (None, 1.25, 2.5)
BATCH_SIZES = (None, 1, 3, 2 ** 31 - 1)


def _pair(points_range, rigor, check, max_batch_size, backend, sigma):
    """The same options in both packages."""
    kw = dict(max_batch_size=max_batch_size, backend=backend,
              upsampling_factor=sigma)
    jax_opts = tfft.Options(
        debugging=tfft.DebuggingOptions(check_points_range=check),
        fftw=tfft.FftwOptions(
            planning_rigor=tfft.FftwPlanningRigor(rigor)),
        points_range=tfft.PointsRange(points_range), **kw)
    port_opts = tnt.Options(
        debugging=tnt.DebuggingOptions(check_points_range=check),
        fftw=tnt.FftwOptions(planning_rigor=tnt.FftwPlanningRigor(rigor)),
        points_range=tnt.PointsRange(points_range), **kw)
    return jax_opts, port_opts


def _same(a: tnt.Options, b: tnt.Options) -> bool:
    fields = ("max_batch_size", "points_range", "backend",
              "upsampling_factor")
    return (all(getattr(a, f) == getattr(b, f) for f in fields)
            and a.debugging == b.debugging and a.fftw == b.fftw)


def _from_jax(opts) -> tnt.Options:
    """The port's options with the serialized fields of JAX ``opts``."""
    return tnt.Options(
        debugging=tnt.DebuggingOptions(
            check_points_range=opts.debugging.check_points_range),
        fftw=tnt.FftwOptions(planning_rigor=int(opts.fftw.planning_rigor)),
        max_batch_size=opts.max_batch_size,
        points_range=int(opts.points_range), backend=opts.backend,
        upsampling_factor=opts.upsampling_factor)


def _rest():
    """Every points range, planning rigor, check flag and batch size."""
    return itertools.product(range(3), range(5), (False, True), BATCH_SIZES)


@pytest.mark.parametrize("sigma", UPSAMPLING)
@pytest.mark.parametrize("backend", BACKENDS)
def test_bytes_equal_jax_and_decode(backend, sigma):
    """The whole product of field values, one case per backend and
    sigma: the port's bytes are the JAX message's serialization, and
    the port decodes the JAX bytes and the JAX message to its own
    options."""
    for rest in _rest():
        jax_opts, port_opts = _pair(*rest, backend, sigma)
        jax_pb = jax_opts.to_proto()
        want = jax_pb.SerializeToString()
        got = port_opts.to_proto()
        assert got == want, (rest, got.hex(), want.hex())
        assert _same(tnt.Options.from_proto(want), port_opts), rest
        assert _same(tnt.Options.from_proto(jax_pb), port_opts), rest
        back = tfft.Options.from_proto(
            nufft_options_pb2.Options.FromString(got))
        assert back == jax_opts, rest


def test_documented_bytes():
    assert tnt.Options().to_proto() == bytes.fromhex("0a0012002001")
    opts = tnt.Options(max_batch_size=3, backend="xla",
                       upsampling_factor=2.5,
                       points_range=tnt.PointsRange.STRICT)
    assert opts.to_proto() == bytes.fromhex(
        "0a0012001803a20603786c61a9060000000000000440")
    assert _same(tnt.Options.from_proto(b""), tnt.Options(
        points_range=tnt.PointsRange.STRICT))


def test_submessages_and_enums():
    dbg = tnt.DebuggingOptions(check_points_range=True)
    fftw = tnt.FftwOptions(planning_rigor=tnt.FftwPlanningRigor.PATIENT)
    assert dbg.to_proto() == tfft.DebuggingOptions(
        check_points_range=True).to_proto().SerializeToString()
    assert fftw.to_proto() == tfft.FftwOptions(
        planning_rigor=tfft.FftwPlanningRigor.PATIENT
    ).to_proto().SerializeToString()
    assert tnt.DebuggingOptions.from_proto(dbg.to_proto()) == dbg
    assert tnt.FftwOptions.from_proto(
        tfft.FftwOptions(planning_rigor=3).to_proto()) == fftw
    for cls in (tnt.PointsRange, tnt.FftwPlanningRigor):
        for member in cls:
            assert cls.from_proto(member.to_proto()) is member


def _key(number, wire_type):
    key, out = (number << 3) | wire_type, bytearray()
    while key > 0x7F:
        out.append(key & 0x7F | 0x80)
        key >>= 7
    return bytes(out) + bytes([key])


UNKNOWN = {
    "varint": _key(7, 0) + b"\xff\xff\x03",
    "fixed64": _key(8, 1) + struct.pack("<d", 1.5),
    "length_delimited": _key(200, 2) + b"\x03abc",
    "fixed32": _key(9, 5) + struct.pack("<f", 2.5),
    "group": _key(10, 3) + _key(1, 0) + b"\x05" + _key(10, 4),
    "wrong_wire_type": _key(3, 2) + b"\x01\x07",
}


@pytest.mark.parametrize("kind", sorted(UNKNOWN))
def test_unknown_fields_skipped(kind):
    """An unknown field of each wire type (and a known number with
    another wire type), before, between and after the known fields,
    in the top message and in a submessage, is skipped, as the
    protobuf parser skips it."""
    extra = UNKNOWN[kind]
    opts = tnt.Options(max_batch_size=5, backend="native",
                       upsampling_factor=1.25,
                       debugging=tnt.DebuggingOptions(
                           check_points_range=True))
    data = opts.to_proto()
    sub = opts.debugging.to_proto() + extra
    cut = 2 + data[1]                   # the end of the debugging field
    variants = [extra + data, data + extra,
                data[:cut] + extra + data[cut:],
                bytes([0x0a, len(sub)]) + sub + data[cut:]]
    for blob in variants:
        assert _same(tnt.Options.from_proto(blob), opts), blob.hex()
        ref = tfft.Options.from_proto(
            nufft_options_pb2.Options.FromString(blob))
        assert _same(tnt.Options.from_proto(blob), _from_jax(ref))


def test_truncated_bytes_raise():
    data = tnt.Options(max_batch_size=300, backend="pallas",
                       upsampling_factor=2.5).to_proto()
    raised = 0
    for end in range(1, len(data)):
        cut = data[:end]
        try:
            ref = nufft_options_pb2.Options.FromString(cut)
        except Exception:
            raised += 1
            with pytest.raises(ValueError):
                tnt.Options.from_proto(cut)
        else:           # a cut at a field boundary is a valid message
            assert _same(tnt.Options.from_proto(cut),
                         _from_jax(tfft.Options.from_proto(ref)))
    assert raised > len(data) // 2
    with pytest.raises(ValueError):
        tnt.Options.from_proto(b"\x0a\x05\x08")          # length past end
    with pytest.raises(ValueError):
        tnt.Options.from_proto(b"\x18" + b"\xff" * 11)   # endless varint
    with pytest.raises(ValueError):
        tnt.Options.from_proto(_key(10, 3) + _key(1, 0) + b"\x01")
    with pytest.raises(TypeError):
        tnt.Options.from_proto("0a00")
    with pytest.raises(ValueError):
        tnt.Options(max_batch_size=2 ** 31).to_proto()


def test_port_modules_load_no_protobuf_or_jax():
    """The codec, the native engine and the profiling module import
    neither protobuf nor jax (the card machine has neither)."""
    import pathlib
    import subprocess
    import sys
    code = ("import sys, tensorflow_nufft_tpu_torch as t; "
            "import tensorflow_nufft_tpu_torch.proto.nufft_options; "
            "import tensorflow_nufft_tpu_torch.native.engine; "
            "t.native.nufft; t.utils.profiling.trace; "
            "t.Options.from_proto(t.Options().to_proto()); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tensorflow_nufft_tpu', 'pydantic') "
            "or m.startswith('google.protobuf')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
