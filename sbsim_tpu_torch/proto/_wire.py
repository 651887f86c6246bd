"""The proto3 wire format: varints, fixed32 floats and length-delimited
fields, encoded and decoded byte for byte as protobuf does.

Wire types: 0 varint (int32, int64, bool, enum), 1 fixed64 (skipped only),
2 length-delimited (string, sub-message, map entry), 5 fixed32 (float).
A negative int32 or int64 is the 10-byte varint of its 64-bit two's
complement.
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

VARINT, FIXED64, LENGTH, FIXED32 = 0, 1, 2, 5

_F32 = struct.Struct("<f")
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


def round_f32(value: float) -> float:
    """`value` rounded to the nearest float32, as a C cast does (inf past
    the largest finite float32)."""
    try:
        return _F32.unpack(_F32.pack(value))[0]
    except OverflowError:
        return math.copysign(math.inf, value)


_ONE_BYTE = tuple(bytes((v,)) for v in range(128))


def encode_varint(value: int) -> bytes:
    """Unsigned varint of `value`; negative values as 64-bit two's
    complement (10 bytes)."""
    if 0 <= value < 128:
        return _ONE_BYTE[value]
    value &= _MASK64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def encode_tag(number: int, wire_type: int) -> bytes:
    return encode_varint((number << 3) | wire_type)


def encode_float(value: float) -> bytes:
    return _F32.pack(value)


def float_is_set(value: float) -> bool:
    """A proto3 float is written when its bits are nonzero: -0.0 and NaN
    are, +0.0 is not."""
    return _F32.pack(value) != b"\0\0\0\0"


def encode_length(payload: bytes) -> bytes:
    return encode_varint(len(payload)) + payload


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """(unsigned value, next position)."""
    result = shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def to_signed(value: int, bits: int) -> int:
    """The low `bits` bits of `value` as a two's-complement integer."""
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def decode_float(data: bytes, pos: int) -> Tuple[float, int]:
    if pos + 4 > len(data):
        raise DecodeError("truncated fixed32")
    return _F32.unpack_from(data, pos)[0], pos + 4


def decode_length(data: bytes, pos: int) -> Tuple[bytes, int]:
    size, pos = decode_varint(data, pos)
    end = pos + size
    if end > len(data):
        raise DecodeError("truncated length-delimited field")
    return data[pos:end], end


def skip_field(data: bytes, pos: int, wire_type: int) -> int:
    """Position after a field of `wire_type` whose tag ends at `pos`."""
    if wire_type == VARINT:
        return decode_varint(data, pos)[1]
    if wire_type == FIXED64:
        pos += 8
    elif wire_type == LENGTH:
        return decode_length(data, pos)[1]
    elif wire_type == FIXED32:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if pos > len(data):
        raise DecodeError("truncated field")
    return pos
