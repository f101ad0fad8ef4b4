"""A small msgpack codec for the repository's flax checkpoints.

Covers what the checkpoints hold: maps, arrays, strings, binary, ints,
floats, booleans, nil, and flax's ndarray extension (type 1): an embedded
msgpack ``[shape, dtype name, buffer]``, turned into a numpy array with
``np.frombuffer``. :func:`packb` writes the same subset as
``flax.serialization.to_bytes`` writes it (the smallest encoding of each
int, float64 floats, maps in insertion order, numpy arrays as type-1
extensions, C order); anything else raises.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_FIXED = {  # type byte -> struct format of a fixed-size value
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {0: ">B", 1: ">H", 2: ">I"}  # 8/16/32-bit length prefixes


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(_LEN[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32: length, then type
            n = self.unpack(_LEN[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(_LEN[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.unpack(_LEN[b - 0xDB]))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(_LEN[b - 0xDD]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported extension type {code}")
        shape, dtype_name, buffer = _Reader(bytes(self.take(n))).obj()
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object (a flax checkpoint) into dicts, lists and
    numpy arrays."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length or size prefix: the fix form below ``fix_max``, else the
    8/16/32-bit code of ``codes`` (``None`` where a width has none)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    widths = ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1))
    if v < 0:
        widths = ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15), (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63))
    for code, fmt, lim in widths:
        if (v <= lim) if v >= 0 else (v >= lim):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: int {v} out of range")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("msgpack: object arrays are not supported")
        payload = packb([list(obj.shape), obj.dtype.name, obj.tobytes("C")])
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)
        else:
            _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode dicts, lists, scalars, strings, bytes and numpy arrays (a flax
    checkpoint)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)
