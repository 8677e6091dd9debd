"""``jax.random``'s threefry2x32 key stream in numpy, for the engine's
random restarts.

The JAX engine draws restarts 2.. of a multi-start search as
``jax.random.randint(fold_in(PRNGKey(17), s), (N,), 0, M)``.  Those draws
depend only on (s, N, M), never on the data, so the port reproduces them
bit for bit without JAX: :func:`prng_key`, :func:`fold_in`, :func:`split`
and :func:`randint` follow ``jax.random`` with
``jax_threefry_partitionable=True`` (the default from jax 0.5 on).  Keys
are (2,) uint32 arrays, as JAX's raw keys are.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)."""
    k1, k2 = (np.asarray(k, np.uint32) for k in key)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the count pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([data], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _bits(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The hash of the counts 0..n-1 (high words 0), the partitionable
    layout of ``jax.random``'s bits and splits."""
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    a, b = _bits(key, num)
    return np.stack([a, b], axis=1)


def random_bits32(key: np.ndarray, n: int) -> np.ndarray:
    """(n,) uint32 random words (``jax.random.bits`` at 32 bits)."""
    a, b = _bits(key, n)
    return a ^ b


def randint(key: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval, int32)``.

    Two 32-bit words a value, folded into the span modulo its size, as
    jax does to keep the bias of a non-power-of-two span small.
    """
    k1, k2 = split(key)
    hi, lo = random_bits32(k1, n), random_bits32(k2, n)
    span = np.uint32(max(maxval - minval, 1))
    mult = np.uint32(2 ** 16) % span
    mult = (mult * mult) % span
    off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def restart_pattern(s: int, N: int, M: int) -> np.ndarray:
    """(N,) int32 random start ``s`` of the engine's multi-start search."""
    return randint(fold_in(prng_key(17), s), N, 0, M)
