"""The JAX package's random draws, reproduced in numpy.

The JAX package draws its initial weights with ``jax.random``
(``PRNGKey``, ``split``, ``normal``) under the default threefry-2x32
generator with partitionable counters.  This module computes the same
keys and the same float32 normals without JAX, so that the port can
start from the reference's own initial weights on a machine that has no
JAX (``repro_torch.convert.jax_init_recsys``, the switching demo model).

Keys are pairs of ``np.uint32``.  Keys and uniform bits are exact; a
normal can land a few ulps from XLA's, because XLA's ``log1p`` may round
differently from numpy's.
"""
from __future__ import annotations

import numpy as np

Key = tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 erf_inv: a polynomial in w = -log1p(-x * x), one set of
# coefficients for w < 5 and one for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    return (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))


def threefry2x32(key: Key, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counters ``(0, i)``, ``i < n``, under ``key``
    (JAX's partitionable counter layout for fewer than 2**32 values)."""
    k = (np.uint32(key[0]), np.uint32(key[1]))
    ks = (k[0], k[1], k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    x0 = np.zeros(n, np.uint32) + ks[0]
    x1 = np.arange(n, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key: Key, n: int = 2) -> list[Key]:
    """``jax.random.split(key, n)``."""
    b0, b1 = threefry2x32(key, n)
    return list(zip(b0, b1))


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA fuses it on the CPU."""
    return (a.astype(np.float64) * b + np.float64(c)).astype(np.float32)


def normal(key: Key, shape: tuple) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: uniform bits in (-1,
    1), then ``sqrt(2) * erf_inv``.  XLA's own ``log1p`` may differ from
    numpy's in the last bit, so a value can land a few ulps away."""
    f32 = np.float32
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(key, n)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.array(1.0, f32).view(np.uint32)
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    u = np.maximum(lo, (bits.view(f32) - f32(1.0)) * (f32(1.0) - lo) + lo)
    w = -np.log1p(u * -u)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, f32(c_lt), f32(c_ge)))
    x = np.where(np.abs(u) == f32(1.0), u * f32(np.inf), p * u)
    return (f32(np.sqrt(2.0)) * x.astype(f32)).reshape(shape)
