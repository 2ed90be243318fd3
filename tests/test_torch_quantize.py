"""The port's wire quantizers on the CPU against the JAX package's Pallas
kernels.

The same payloads, made with numpy from a seed, go through the JAX
package's ``quantize_minmax``, ``quantize_sign`` and ``dequantize`` in
interpret mode and through the port's wrappers on CPU tensors (their plain
versions in ``repro_torch.kernels.ref``).  Payloads mix magnitudes from
1e-20 to 1e5 across rows and tiles, hold constant tiles and tiles of
signed zeros, and stay in float32's normal range: XLA on the CPU flushes
subnormals to zero, where PyTorch and CUDA keep them.

Tolerances: min-max codes, scale, zero point and residual, and both
dequantizes on the same wire arrays, are bit-exact.  Sign codes are
exact; the sign scale is XLA's mean of |x| in its own reduction order,
which no fixed order reproduces, so the port's (a float64 sum in the
kernel's lane order) is held within 4 float32 ulps of it,
and its residual is exactly ``x - q * scale`` with the port's scale.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as Q
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as K
from repro_torch.kernels.ref import (SIGN_LANES, dequantize_ref, fma_f32,
                                     quantize_minmax_ref, quantize_sign_ref)

SIGN_ULPS = 4


def _payload(r, tiles, tile, seed):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.integers(-20, 6, (r, tiles, 1))
    x = (rng.standard_normal((r, tiles, tile)) * mag).astype(np.float32)
    x[0, 0] = 0.0                              # zeros of both signs
    x[0, 0, 1::3] = -0.0
    if tiles > 1:
        x[-1, 1] = np.float32(1.5)             # a constant tile
    if tiles > 2:
        x[-1, 2] = -np.abs(x[-1, 2])           # a tile of one sign
        x[-1, 2, ::2] = -0.0
    return x.reshape(r, tiles * tile)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


CASES = [(256, 1, 6), (256, 3, 5), (256, 4, 9), (2048, 1, 3), (2048, 4, 4),
         (2048, 2, 1)]


@pytest.mark.parametrize("tile,r,tiles", CASES)
def test_minmax_matches_the_pallas_kernel(tile, r, tiles):
    x = _payload(r, tiles, tile, seed=tile + r)
    want = [np.asarray(a) for a in
            Q.quantize_minmax(jnp.asarray(x), tile=tile, interpret=True)]
    # a strided view: the payload is columns of a wider buffer, and the
    # residual is written back into them
    buf = torch.full((r, x.shape[1] + 3 * tile), 7.0)
    view = buf[:, tile:tile + x.shape[1]]
    view.copy_(torch.from_numpy(x))
    q, scale, zero = K.quantize_minmax(view, tile=tile)
    for name, got, w in zip(("q", "scale", "zero", "residual"),
                            (q, scale, zero, view), want):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(w),
                                      err_msg=name)
    assert (buf[:, :tile] == 7).all() and (buf[:, tile + x.shape[1]:] == 7
                                           ).all()
    jd = np.asarray(Q.dequantize(*(jnp.asarray(a) for a in want[:3]),
                                 tile=tile, mode="minmax", interpret=True))
    out = torch.empty(x.shape)
    K.dequantize(*(torch.from_numpy(a) for a in want[:3]), tile=tile,
                 mode="minmax", out=out)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(jd))
    # error feedback: the residual is what the dequantize misses, exactly
    np.testing.assert_array_equal(_bits(view.numpy()),
                                  _bits(x - out.numpy()))


@pytest.mark.parametrize("tile,r,tiles", CASES)
def test_sign_matches_the_pallas_kernel(tile, r, tiles):
    x = _payload(r, tiles, tile, seed=100 + tile + r)
    jq, js, jr = (np.asarray(a) for a in
                  Q.quantize_sign(jnp.asarray(x), tile=tile, interpret=True))
    t = torch.from_numpy(x.copy())
    q, scale = K.quantize_sign(t, tile=tile)
    np.testing.assert_array_equal(q.numpy(), jq)
    ulps = np.abs(_bits(scale.numpy()).astype(np.int64) - _bits(js))
    assert ulps.max() <= SIGN_ULPS, ulps.max()
    qs = (q.float().reshape(r, tiles, tile) * scale[..., None]).reshape(
        x.shape)
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(x - qs.numpy()))
    # against the reference's residual: off by the scales' gap, plus one
    # rounding of the residual
    gap = np.abs(t.numpy() - jr).reshape(r, tiles, tile)
    bound = (np.abs(scale.numpy() - js)[..., None]
             + np.spacing(np.abs(jr)).reshape(r, tiles, tile))
    assert (gap <= bound).all()
    jd = np.asarray(Q.dequantize(jnp.asarray(jq), jnp.asarray(js),
                                 tile=tile, mode="sign", interpret=True))
    out = torch.empty(x.shape)
    K.dequantize(torch.from_numpy(jq), torch.from_numpy(js), None,
                 tile=tile, mode="sign", out=out)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(jd))


def test_sign_scale_sums_in_the_kernels_lane_order():
    """Lane t of 256 adds |x[t]|, |x[t + 256]|, ... from 0.0 in float64;
    lane t then adds lane t + s for s = 128, ..., 1; the sum over the tile
    length is rounded once to float32.  Tile 300 leaves lanes 44..255 one
    element short."""
    tile = 300
    x = _payload(2, 3, tile, seed=5)
    _, scale, _ = quantize_sign_ref(torch.from_numpy(x), tile)
    a = np.abs(x.astype(np.float64)).reshape(2, 3, tile)
    lanes = np.zeros((2, 3, SIGN_LANES))
    for i in range(tile):
        lanes[..., i % SIGN_LANES] += a[..., i]
    s = SIGN_LANES
    while s > 1:
        s //= 2
        lanes[..., :s] += lanes[..., s:2 * s]
    np.testing.assert_array_equal(
        _bits(scale.numpy()), _bits((lanes[..., 0] / tile).astype(np.float32)))


def _round_f32(v: Fraction) -> float:
    """The float32 nearest to ``v``, ties to even (normal and subnormal
    range)."""
    if v == 0:
        return 0.0
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    if Fraction(2) ** e > v:
        e -= 1
    ulp = Fraction(2) ** max(e - 23, -149)
    return sign * float(round(v / ulp) * ulp)


def test_fma_rounds_once():
    """``fma_f32`` against exact rational arithmetic: random operands with
    wide exponent gaps, and a case whose float64 sum lands on a float32
    tie (1 + 2**-24 + 2**-60), where rounding twice would give 1.0."""
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)
         ).astype(np.float32)
    a[0], b[0], c[0] = -(1 - 2.0**-18), 2.0**-24 * (1 + 2.0**-18), \
        1 + 2.0**-23
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.float32([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)])
    assert got[0] == np.float32(1 + 2.0**-23)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wire_ops_dispatch_and_count_calls():
    x = torch.from_numpy(_payload(4, 2, 256, seed=8))
    want = quantize_minmax_ref(x, 256)
    calls = dict(ops.kernel_calls)
    launches = (K.quantize_minmax.launches, K.quantize_sign.launches,
                K.dequantize.launches)
    y = x.clone()
    q, scale, zero = ops.quantize_wire(y, tile=256, mode="minmax")
    out = ops.dequantize_wire(q, scale, zero, tile=256, mode="minmax",
                              out=torch.empty_like(x))
    assert torch.equal(out, dequantize_ref(q, scale, zero, 256, "minmax"))
    for got, w in zip((q, scale, zero, y), want):
        assert torch.equal(got, w)
    z = x.clone()
    q, scale = ops.quantize_wire(z, tile=256, mode="sign")
    ops.dequantize_wire(q, scale, tile=256, mode="sign", out=out)
    assert torch.equal(z, x - out)
    assert ops.kernel_calls["quantize_wire"] == calls.get(
        "quantize_wire", 0) + 2
    assert ops.kernel_calls["dequantize_wire"] == calls.get(
        "dequantize_wire", 0) + 2
    # CPU tensors take the plain versions: no kernel launched
    assert (K.quantize_minmax.launches, K.quantize_sign.launches,
            K.dequantize.launches) == launches
    with pytest.raises(ValueError, match="mode"):
        ops.quantize_wire(x.clone(), tile=256, mode="fp4")


@pytest.mark.parametrize("bad", ["tile", "columns", "stride", "dtype",
                                 "empty", "zero", "out"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 512))
    q, s = torch.zeros((2, 512), dtype=torch.int8), torch.zeros((2, 2))
    calls = {
        "tile": lambda: K.quantize_minmax(x, tile=0),
        "columns": lambda: K.quantize_sign(x, tile=300),
        "stride": lambda: K.quantize_minmax(x.t(), tile=2),
        "dtype": lambda: K.quantize_minmax(x.double(), tile=256),
        "empty": lambda: K.quantize_sign(x[:0], tile=256),
        "zero": lambda: K.dequantize(q, s, None, tile=256, mode="minmax",
                                     out=x),
        "out": lambda: K.dequantize(q, s, None, tile=256, mode="sign",
                                    out=x[:, :256]),
    }
    with pytest.raises((ValueError, TypeError)):
        calls[bad]()
