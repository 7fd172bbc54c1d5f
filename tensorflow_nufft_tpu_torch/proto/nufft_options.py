"""Proto3 codec of the options schema (``nufft_options.proto`` of the
JAX package, the reference's field numbers), written by hand: the
port's users may have no protobuf, and the schema is six scalars in
three messages.

Schema::

    message Options {
      DebuggingOptions debugging = 1;    // always written, maybe empty
      FftwOptions fftw = 2;              // always written, maybe empty
      int32 max_batch_size = 3;
      PointsRange points_range = 4;      // enum
      string backend = 100;              // extension, absent if "auto"
      double upsampling_factor = 101;    // extension, absent if unset
    }
    message DebuggingOptions { bool check_points_range = 1; }
    message FftwOptions { FftwPlanningRigor planning_rigor = 1; }

Encoding follows protobuf's serializer byte for byte: fields in number
order, proto3 zero scalars omitted, a submessage present whenever its
parent marks it set. Decoding skips unknown fields by wire type, lets
the last occurrence of a scalar win and merges repeated submessages,
as protobuf's parser does; malformed or truncated bytes raise
``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

VARINT, FIXED64, LEN, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5
INT32_MAX = 2 ** 31 - 1

# Field numbers.
DEBUGGING, FFTW, MAX_BATCH_SIZE, POINTS_RANGE = 1, 2, 3, 4
BACKEND, UPSAMPLING_FACTOR = 100, 101
CHECK_POINTS_RANGE = PLANNING_RIGOR = 1


def _varint(value: int) -> bytes:
    """Base-128 varint of a non-negative int (negative int32s are
    sign-extended to 64 bits first, as protobuf writes them)."""
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        low = value & 0x7F
        value >>= 7
        if value:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _len_field(number: int, payload: bytes) -> bytes:
    return _key(number, LEN) + _varint(len(payload)) + payload


def encode_debugging(check_points_range: bool) -> bytes:
    """Serialized ``DebuggingOptions``."""
    if not check_points_range:
        return b""
    return _key(CHECK_POINTS_RANGE, VARINT) + _varint(1)


def encode_fftw(planning_rigor: int) -> bytes:
    """Serialized ``FftwOptions``."""
    if not planning_rigor:
        return b""
    return _key(PLANNING_RIGOR, VARINT) + _varint(int(planning_rigor))


def encode_options(debugging: bytes, fftw: bytes, max_batch_size,
                   points_range: int, backend: str,
                   upsampling_factor) -> bytes:
    """Serialized ``Options`` from its serialized submessages and scalars
    (``max_batch_size``/``upsampling_factor`` None when unset)."""
    out = _len_field(DEBUGGING, debugging) + _len_field(FFTW, fftw)
    if max_batch_size is not None:
        if not -2 ** 31 <= max_batch_size <= INT32_MAX:
            raise ValueError(f"Value out of range: {max_batch_size}")
        if max_batch_size:
            out += _key(MAX_BATCH_SIZE, VARINT) + _varint(max_batch_size)
    if points_range:
        out += _key(POINTS_RANGE, VARINT) + _varint(int(points_range))
    if backend != "auto":
        out += _len_field(BACKEND, backend.encode("utf-8"))
    if upsampling_factor is not None and upsampling_factor != 0.0:
        out += (_key(UPSAMPLING_FACTOR, FIXED64)
                + struct.pack("<d", upsampling_factor))
    return out


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint in options message")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes in options "
                             "message")


def _take(data: bytes, pos: int, size: int) -> Tuple[bytes, int]:
    if pos + size > len(data):
        raise ValueError("truncated field in options message")
    return data[pos:pos + size], pos + size


def _fields(data: bytes, group: int = 0, pos: int = 0):
    """Yields (number, wire type, value, end position) of each field of a
    message (``group``: of a group's body, up to its end tag); a varint's
    value is an int, a fixed one's and a length-delimited one's bytes."""
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire_type = key >> 3, key & 7
        if number == 0:
            raise ValueError("field number 0 in options message")
        if wire_type == VARINT:
            value, pos = _read_varint(data, pos)
        elif wire_type == FIXED64:
            value, pos = _take(data, pos, 8)
        elif wire_type == LEN:
            size, pos = _read_varint(data, pos)
            value, pos = _take(data, pos, size)
        elif wire_type == FIXED32:
            value, pos = _take(data, pos, 4)
        elif wire_type == START_GROUP:
            for _, _, _, end in _fields(data, group=number, pos=pos):
                pass
            value, pos = None, end
        elif wire_type == END_GROUP:
            if number != group:
                raise ValueError("unmatched end-group tag in options "
                                 "message")
            yield number, wire_type, None, pos
            return
        else:
            raise ValueError(f"invalid wire type {wire_type} in options "
                             f"message")
        yield number, wire_type, value, pos
    if group:
        raise ValueError("truncated group in options message")


def _int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _decode_message(data: bytes, schema: Dict[int, Tuple[int, str]]
                    ) -> dict:
    """Known fields of one message as {name: value}; fields of an
    unknown number or another wire type than the schema's are
    skipped."""
    out = {}
    for number, wire_type, value, _ in _fields(bytes(data)):
        expect = schema.get(number)
        if expect is None or expect[0] != wire_type:
            continue
        name = expect[1]
        if wire_type == LEN and name in ("debugging", "fftw"):
            out[name] = out.get(name, b"") + value     # merge, as protobuf
        elif wire_type == LEN:
            try:
                out[name] = value.decode("utf-8")
            except UnicodeDecodeError:
                raise ValueError(f"field {name} is not valid UTF-8") \
                    from None
        elif wire_type == FIXED64:
            out[name] = struct.unpack("<d", value)[0]
        else:
            out[name] = value
    return out


_OPTIONS = {DEBUGGING: (LEN, "debugging"), FFTW: (LEN, "fftw"),
            MAX_BATCH_SIZE: (VARINT, "max_batch_size"),
            POINTS_RANGE: (VARINT, "points_range"),
            BACKEND: (LEN, "backend"),
            UPSAMPLING_FACTOR: (FIXED64, "upsampling_factor")}


def decode_debugging(data: bytes) -> bool:
    """``check_points_range`` of a serialized ``DebuggingOptions``."""
    fields = _decode_message(data, {CHECK_POINTS_RANGE: (VARINT, "v")})
    return bool(fields.get("v", 0))


def decode_fftw(data: bytes) -> int:
    """``planning_rigor`` of a serialized ``FftwOptions``."""
    fields = _decode_message(data, {PLANNING_RIGOR: (VARINT, "v")})
    return _int32(fields.get("v", 0))


def decode_options(data: bytes) -> dict:
    """The fields of a serialized ``Options``, proto3 defaults filled in:
    ``debugging`` (bool), ``fftw`` (int), ``max_batch_size``,
    ``points_range`` (ints), ``backend`` (str), ``upsampling_factor``
    (float)."""
    fields = _decode_message(data, _OPTIONS)
    return {
        "debugging": decode_debugging(fields.get("debugging", b"")),
        "fftw": decode_fftw(fields.get("fftw", b"")),
        "max_batch_size": _int32(fields.get("max_batch_size", 0)),
        "points_range": _int32(fields.get("points_range", 0)),
        "backend": fields.get("backend", ""),
        "upsampling_factor": fields.get("upsampling_factor", 0.0),
    }


def as_bytes(pb) -> bytes:
    """Serialized bytes of ``pb``: bytes as they are, or a protobuf
    message (anything with ``SerializeToString``) serialized."""
    if isinstance(pb, (bytes, bytearray, memoryview)):
        return bytes(pb)
    serialize = getattr(pb, "SerializeToString", None)
    if serialize is None:
        raise TypeError(
            f"from_proto takes serialized bytes or a protobuf message, got "
            f"{type(pb).__name__}")
    return serialize()
