"""Counter-based random bits, equal bit for bit to ``jax.random`` under the
threefry2x32 implementation with ``jax_threefry_partitionable=True``.

Keys are carried as key data: a pair ``(k0, k1)`` of uint32 (``(0, s)`` is
``jax.random.key(s)`` for ``0 <= s < 2**32``).  Only the two operations the
simulator needs are provided: :func:`split` into ``n`` keys (the AdaptSize
admission coin, the hierarchy's per-tier keys) and :func:`uniform` for one
f32 scalar in ``[0, 1)``.  Each key and each
draw is one threefry2x32 block on the host; no kernel is involved.
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """The Threefry-2x32 block function (20 rounds) of key ``(k0, k1)`` on
    the counter ``(x0, x1)``."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key, n: int = 2) -> tuple[tuple[int, int], ...]:
    """``jax.random.split(key, n)``: key ``i`` is the block at counter
    ``(0, i)`` (``jax_threefry_partitionable=True``)."""
    k0, k1 = (int(k) for k in key)
    return tuple(threefry2x32(k0, k1, 0, i) for i in range(n))


def uniform(key) -> np.float32:
    """``jax.random.uniform(key)`` for an f32 scalar: the top 23 of the 32
    bits ``b0 ^ b1`` of the block at counter ``(0, 0)`` fill the mantissa of
    a float in ``[1, 2)``, less 1."""
    b0, b1 = threefry2x32(int(key[0]), int(key[1]), 0, 0)
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return max(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def key_data(seed: int) -> tuple[int, int]:
    """The key data of ``jax.random.key(seed)`` (threefry): the seed's high
    and low 32-bit words."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32
