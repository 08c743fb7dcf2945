"""The interval family's rank draw, ``jax.random.randint(PRNGKey(seed),
(n, dim), lo, hi, int32)``, and the training step's ``fold_in``, in
numpy, bit for bit.

The reference draws its ranks with JAX's default PRNG: threefry2x32 with
the partitionable key split and bit stream.  Same seed ⇒ same ranks ⇒
same interval planes, so the port computes the same stream:

- the key of a 32-bit seed is ``(0, seed mod 2**32)``;
- ``randint`` splits it into two subkeys: threefry of the counters
  ``(0, 0)`` and ``(0, 1)``;
- each subkey draws 32-bit words: threefry of the 64-bit counter ``i``
  (high word, low word) at flat element ``i``, the two output words XORed;
- the range map: ``span = hi - lo`` in uint32, ``multiplier =
  (2**16 mod span)**2 mod span``, ``offset = ((high mod span) * multiplier
  + (low mod span)) mod span``, all in wrapping uint32, and ``lo + offset``.

All arithmetic is ``np.uint32``, which wraps as JAX's does.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The 20-round threefry2x32 hash of the counter words ``(x1, x2)``
    under the key ``(k1, k2)``; returns the two output word arrays."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def seed_key(seed: int) -> tuple[np.uint32, np.uint32]:
    """``PRNGKey(seed)`` for a seed that fits int32 (the reference's jit
    takes it as an int32 operand): high word 0, low word the seed's two's
    complement."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32")
    return _U32(0), _U32(seed & 0xFFFFFFFF)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``: threefry
    of the counter words ``(0, data)`` (``threefry_seed(data)``) under
    ``key``; a (2,) uint32 key."""
    o1, o2 = threefry2x32(key[0], key[1], np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([o1[0], o2[0]], _U32)


def _counters(size: int):
    idx = np.arange(size, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def random_bits(key, shape) -> np.ndarray:
    """32-bit words of the partitionable stream at flat indices."""
    size = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(*key, *_counters(size))
    return (b1 ^ b2).reshape(shape)


def split2(key):
    """``jax.random.split(key)``: the two subkeys."""
    b1, b2 = threefry2x32(*key, *_counters(2))
    return (b1[0], b2[0]), (b1[1], b2[1])


def randint(seed: int, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 ``jax.random.randint(PRNGKey(seed), shape, minval, maxval)``
    for int32 bounds with ``minval < maxval``."""
    if not -2 ** 31 <= minval < maxval < 2 ** 31:
        raise ValueError("bounds must satisfy -2**31 <= minval < maxval "
                         "< 2**31")
    k_hi, k_lo = split2(seed_key(seed))
    higher, lower = random_bits(k_hi, shape), random_bits(k_lo, shape)
    span = _U32((maxval - minval) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + (lower % span)) % span
        return (np.int32(minval) + offset.view(np.int32)).astype(np.int32)
