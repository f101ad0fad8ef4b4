"""A small msgpack decoder for the repository's flax checkpoints.

Covers what the checkpoints hold: maps, arrays, strings, binary, ints,
floats, and flax's ndarray extension (type 1): an embedded msgpack
``[shape, dtype name, buffer]`` turned into a numpy array with
``np.frombuffer``. Anything else raises.
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
