"""``jax.random``'s default generator (Threefry-2x32, in the
``jax_threefry_partitionable`` mode that jax 0.9 uses by default), in numpy,
bit for bit: ``prng_key``, ``fold_in``, ``split`` and ``uniform``, as far as
the guided-quality proxy draws its cutout coordinates
(``guided_quality_proxy.step_coords``). Keys are ``uint32`` arrays of shape
[2]; nothing here imports jax.

    key = fold_in(prng_key(123), 7)
    k_size, k_x, k_y = split(key, 3)
    u = uniform(k_size, (16,))
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) of the counters
    (x0, x1) under the key (k1, k2), elementwise over x0 and x1: the pair of
    uint32 arrays jax's ``threefry2x32_p`` returns."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            # the key injection after every four rounds, with the round counter
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: [0, seed]."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed with [0, data]."""
    a, b = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                        np.array([data & 0xFFFFFFFF], np.uint32))
    return np.concatenate([a, b])


def _bits(key: np.ndarray, n: int):
    """The two Threefry words of the counters 0 .. n-1 (a 64-bit iota split
    into its high and low words)."""
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(np.uint32)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32 keys."""
    a, b = _bits(key, num)
    return np.stack([a, b], axis=1)


def uniform(key: np.ndarray, shape=(), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top 23
    bits of ``b1 ^ b2`` as the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval), then floored at minval. XLA fuses the scale
    and the shift into one multiply-add rounded once to f32; here the
    product is exact in f64 and the sum is rounded from there."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    a, b = _bits(key, int(np.prod(shape, dtype=np.int64)))
    mant = ((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)
