"""A self-contained msgpack codec for the artifacts that flax writes.

``flax.serialization.msgpack_serialize`` writes a dict of arrays as a
msgpack map with sorted str keys whose array leaves are ext type 1, holding
the msgpack array ``(shape, dtype name, C-order bytes)``. This module reads
and writes that subset byte for byte, without the ``msgpack`` package: maps
with str keys, arrays (lists), nil, bools, ints, floats, str, bin and ext
type 1. Anything else raises, including flax's chunked form of arrays above
2**30 bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_MAX_ARRAY_BYTES = 2**30  # flax chunks arrays above this; the codec does not
_CHUNKED_KEY = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# Encoding (msgpack-python's choices: the smallest form of each value)
# ---------------------------------------------------------------------------


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -32 <= v < 0:
        return struct.pack("b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in msgpack")


def _pack_len(n: int, fix: Tuple[int, int], sized: Tuple[Tuple[int, str, int], ...]) -> bytes:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``n < fix[1]`` (if any), else the first sized form that holds it."""
    if fix[1] and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in sized:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit in msgpack")


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    head = _pack_len(len(data), (0xA0, 32),
                     ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
    return head + data


def _pack_bin(data: bytes) -> bytes:
    head = _pack_len(len(data), (0, 0),
                     ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
    return head + data


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _pack_len(len(data), (0, 0),
                         ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
    return head + struct.pack("b", code) + data


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError(f"cannot serialize arrays of dtype {arr.dtype}")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes is above 2**30; flax "
                         "would write it chunked, which this codec does not")
    payload = pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return _pack_ext(_EXT_NDARRAY, payload)


def pack(obj: Any) -> bytes:
    """msgpack bytes of ``obj``; dict keys are written in sorted order."""
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ndarray(obj)
    if isinstance(obj, np.generic):
        # flax writes numpy scalars as ext type 3; wrap them in np.asarray
        raise TypeError(f"cannot serialize numpy scalar {type(obj).__name__}")
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        return _pack_str(obj)
    if isinstance(obj, (bytes, bytearray)):
        return _pack_bin(bytes(obj))
    if isinstance(obj, (list, tuple)):
        head = _pack_len(len(obj), (0x90, 16),
                         ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        return head + b"".join(pack(x) for x in obj)
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("only str map keys are supported")
        head = _pack_len(len(obj), (0x80, 16),
                         ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        return head + b"".join(pack(k) + pack(obj[k]) for k in sorted(obj))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _unpack_ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpack(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise TypeError(f"array dtype {dtype_name!r} is not supported") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
    if b in ints:
        return r.unpack(ints[b])
    sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
             0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
             0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext or b in (0xC7, 0xC8, 0xC9):
        n = fixext[b] if b in fixext else r.unpack(sizes[b])
        code = r.unpack("b")
        data = bytes(r.take(n))
        if code != _EXT_NDARRAY:
            raise TypeError(f"msgpack ext type {code} is not supported")
        return _unpack_ndarray(data)
    if b in sizes:
        n = r.unpack(sizes[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(r.take(n)).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise TypeError(f"msgpack type byte 0x{b:02x} is not supported")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, str):
            raise TypeError("only str map keys are supported")
        out[key] = _read(r)
    if _CHUNKED_KEY in out:
        raise ValueError("chunked arrays (above 2**30 bytes) are not supported")
    return out


def unpack(data: bytes) -> Any:
    """Decode one msgpack value; arrays come back as writable numpy arrays."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out
