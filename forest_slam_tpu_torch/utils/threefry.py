"""``jax.random``'s threefry draws, in numpy.

The JAX package's benchmark renders worlds drawn from
``jax.random.PRNGKey(0)``, and the accuracy gates' bounds were set in those
worlds. The port imports no JAX, so it reproduces the three calls the worlds
make, bit for bit: ``PRNGKey``, ``split`` and float32 ``uniform``, under
JAX's default partitionable threefry (``jax_threefry_partitionable``, the
default since JAX 0.5): a counter of 64-bit indices hashed by Threefry-2x32
(20 rounds), the two output words xor-ed into 32 random bits, whose top 23
bits fill the mantissa of a float in [1, 2); the scale to [minval, maxval)
is one fused multiply-add, as XLA compiles it on the CPU.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs (x1, x2) under the key (k1, k2)."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps
        a = np.asarray(x1, np.uint32) + ks[0]
        b = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = (b << np.uint32(r)) | (b >> np.uint32(32 - r))
                b = a ^ b
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """The high and low words of a 64-bit iota of ``shape``."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^31): (2,) uint32."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32."""
    b1, b2 = threefry2x32(key[0], key[1], *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def uniform(key: np.ndarray, shape=(), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` in
    float32."""
    b1, b2 = threefry2x32(key[0], key[1], *_counters(tuple(shape)))
    bits = (b1 ^ b2) >> np.uint32(32 - 23) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # floats * (hi - lo) + lo rounded once: the float64 product is exact
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)
