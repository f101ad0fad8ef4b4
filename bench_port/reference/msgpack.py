"""A msgpack reader for flax checkpoints: maps, arrays, strings, binary,
ints, floats, booleans, nil and flax's ndarray extension (type 1, an embedded
``[shape, dtype name, buffer]``)."""

from __future__ import annotations

import struct

import numpy as np

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0: ">B", 1: ">H", 2: ">I"}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return {self.obj(): self.obj() for _ in range(b & 0x0F)}
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.num(_FIXED[b])
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.num(_LEN[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            n = self.num(_LEN[b - 0xC7])
            return self.ext(self.num(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.num(">b"), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return bytes(self.take(self.num(_LEN[b - 0xD9]))).decode()
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.num(_LEN[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return {self.obj(): self.obj() for _ in range(self.num(_LEN[b - 0xDD]))}
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def ext(self, code, n):
        if code != 1:
            raise ValueError(f"msgpack: unsupported extension {code}")
        shape, dtype, buf = _Reader(bytes(self.take(n))).obj()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def read_checkpoint(path: str):
    """(meta dict, params tree) of a flax checkpoint file."""
    with open(path, "rb") as f:
        state = _Reader(f.read()).obj()
    if isinstance(state, dict) and "__meta__" in state:
        return dict(state["__meta__"]), state["params"]
    return {}, state
