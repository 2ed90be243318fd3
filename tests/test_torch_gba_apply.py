"""The port's gba_apply on the CPU against the JAX package's kernel.

The same param, accumulator, buffer and tokens, made with numpy from a
seed, go through the JAX package's Pallas ``gba_apply`` in interpret mode
and through the port's wrapper on CPU tensors (its plain version,
``gba_apply_ref``).

The two agree bit for bit, the bfloat16 cases included: XLA computes the
kernel's weighted sum of the M slots one slot after another with a fused
multiply-add, and the accumulator as ``fma(g, g, accum)``, and the plain
version rounds each of those once too (``kernels.ref.fma_f32``).  Where
every slot is stale, both leave param and accumulator bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gba import flat_buffer_push_and_maybe_apply as jax_push_apply
from repro.core.gba import init_flat_buffer as jax_init_flat_buffer
from repro.kernels.gba_apply import gba_apply as jax_gba_apply
from repro.kernels.ref import gba_apply_ref as jax_two_pass_ref
from repro_torch.convert import params_from_jax
from repro_torch.core.gba import (flat_buffer_push_and_maybe_apply,
                                  init_flat_buffer)
from repro_torch.kernels import ops
from repro_torch.kernels.gba_apply import gba_apply
from repro_torch.kernels.ref import gba_apply_ref

N = 5000                     # not a multiple of the TPU kernel's 2048 block
STEP, IOTA, LR = 7, 2, 0.05


def _inputs(m, n, param_dtype, buf_dtype, stale, seed=0):
    rng = np.random.default_rng(seed)
    param = rng.standard_normal(n).astype(np.float32)
    accum = (0.1 + rng.random(n)).astype(np.float32)
    buffer = rng.standard_normal((m, n)).astype(np.float32)
    tokens = np.full(m, STEP, np.int32)
    if stale == "some":          # ages 0, 3, 1, 3, ... against iota 2
        tokens[1::2] = STEP - IOTA - 1
        tokens[2::4] = STEP - 1
    elif stale == "all":
        tokens[:] = STEP - IOTA - 1
    if param_dtype == "bfloat16":
        param = param.astype(jnp.bfloat16)
    if buf_dtype == "bfloat16":
        buffer = buffer.astype(jnp.bfloat16)
    return param, accum, buffer, tokens


def _jax(param, accum, buffer, tokens):
    p, a = jax_gba_apply(jnp.asarray(param), jnp.asarray(accum),
                         jnp.asarray(buffer), jnp.asarray(tokens),
                         jnp.int32(STEP), LR, iota=IOTA, interpret=True)
    return np.asarray(p).astype(np.float32), np.asarray(a)


def _port(param, accum, buffer, tokens):
    p, a, b, t = params_from_jax((param, accum, buffer, tokens),
                                 device="cpu")
    gba_apply(p, a, b, t, STEP, LR, iota=IOTA)
    return p.float().numpy(), a.numpy()


@pytest.mark.parametrize("m", [1, 3, 4, 8])
@pytest.mark.parametrize("param_dtype,buf_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_matches_the_jax_kernel(m, param_dtype, buf_dtype):
    ins = _inputs(m, N, param_dtype, buf_dtype, "some" if m > 1 else "none",
                  seed=m)
    (jp, ja), (tp, ta) = _jax(*ins), _port(*ins)
    np.testing.assert_array_equal(ta.view(np.uint32), ja.view(np.uint32))
    np.testing.assert_array_equal(tp.view(np.uint32), jp.view(np.uint32))
    # the update happened: kept slots grew the accumulator (g * g may round
    # away against it where g is tiny)
    assert (ta >= ins[1]).all() and (ta > ins[1]).mean() > 0.9


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_all_stale_leaves_param_and_accum_bit_identical(param_dtype):
    param, accum, buffer, tokens = _inputs(4, N, param_dtype, "float32",
                                           "all")
    want_p = np.asarray(param).astype(np.float32)
    for p, a in (_jax(param, accum, buffer, tokens),
                 _port(param, accum, buffer, tokens)):
        np.testing.assert_array_equal(p.view(np.uint32),
                                      want_p.view(np.uint32))
        np.testing.assert_array_equal(a.view(np.uint32),
                                      accum.view(np.uint32))


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, in numpy: the exact product and
    the float64 sum rounded to odd (the neighbour with an odd last bit
    where the sum is inexact), then rounded to float32."""
    p = a.astype(np.float64) * b
    c = np.asarray(c, np.float64)
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf,
                                                           -np.inf)), s)
    return s.astype(np.float32)


def _kernel_order(param, accum, buffer, tokens, m):
    """The TPU kernel's arithmetic as XLA computes it, in numpy float32,
    one correctly rounded operation at a time: weights keep / M taken
    before the sum, slots summed in order from slot 0 with a fused
    multiply-add, the accumulator ``fma(g, g, accum)``, the new param
    rounded once to its dtype."""
    f = np.float32
    buffer = np.asarray(buffer).astype(f)
    w = ((STEP - tokens) <= IOTA).astype(f) / f(m)
    g = buffer[0] * w[0]
    for j in range(1, m):
        g = _fma(buffer[j], w[j], g)
    a = _fma(g, g, accum)
    p = np.asarray(param).astype(f) - (f(LR) * g) / (np.sqrt(a) + f(1e-10))
    return p.astype(np.asarray(param).dtype).astype(f), a


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("param_dtype,buf_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16")])
def test_bit_for_bit_the_kernel_order_in_numpy(m, param_dtype, buf_dtype):
    """The plain version, which the CUDA kernel is held to bit for bit on
    the card, is the kernel's arithmetic with every operation correctly
    rounded (the square root included)."""
    ins = _inputs(m, N, param_dtype, buf_dtype, "some", seed=20 + m)
    want_p, want_a = _kernel_order(*ins, m)
    got_p, got_a = _port(*ins)
    np.testing.assert_array_equal(got_p.view(np.uint32),
                                  want_p.view(np.uint32))
    np.testing.assert_array_equal(got_a.view(np.uint32),
                                  want_a.view(np.uint32))


def test_m3_follows_the_kernels_weights_not_the_two_pass_oracle():
    """With M = 3, ``sum(buf * keep) / 3`` (``repro.kernels.ref``) and
    ``sum(buf * (keep / 3))`` (the kernel) round differently.  The port
    takes the kernel's weights: bit for bit the kernel's order in numpy,
    and not the oracle's on some columns."""
    m = 3
    param, accum, buffer, tokens = _inputs(m, N, "float32", "float32",
                                           "none", seed=11)
    want_p, want_a = _kernel_order(param, accum, buffer, tokens, m)
    got_p, got_a = _port(param, accum, buffer, tokens)
    np.testing.assert_array_equal(got_p.view(np.uint32),
                                  want_p.view(np.uint32))
    np.testing.assert_array_equal(got_a.view(np.uint32),
                                  want_a.view(np.uint32))
    two_p, two_a = (np.asarray(x) for x in jax_two_pass_ref(
        jnp.asarray(param), jnp.asarray(accum), jnp.asarray(buffer),
        jnp.asarray(tokens), jnp.int32(STEP), LR, iota=IOTA))
    assert (two_a.view(np.uint32) != got_a.view(np.uint32)).sum() > N // 100
    jax_p, jax_a = _jax(param, accum, buffer, tokens)
    np.testing.assert_array_equal(got_a.view(np.uint32),
                                  jax_a.view(np.uint32))
    np.testing.assert_array_equal(got_p.view(np.uint32),
                                  jax_p.view(np.uint32))


def test_updates_in_place_and_counts_the_flat_call():
    param, accum, buffer, tokens = (torch.from_numpy(x) for x in _inputs(
        4, 64, "float32", "float32", "some"))
    want_p, want_a = gba_apply_ref(param, accum, buffer, tokens, STEP, LR,
                                   iota=IOTA)
    calls = ops.kernel_calls["gba_apply_flat"]
    p, a = ops.gba_apply_flat(param, accum, buffer, tokens, STEP, LR,
                              iota=IOTA)
    assert ops.kernel_calls["gba_apply_flat"] == calls + 1
    assert p is param and a is accum
    assert torch.equal(param, want_p) and torch.equal(accum, want_a)


@pytest.mark.parametrize("bad", ["accum-bf16", "tokens-int64", "param-f16",
                                 "shape", "no-slots"])
def test_rejects_what_the_kernel_does_not_take(bad):
    param, accum, buffer, tokens = (torch.from_numpy(x) for x in _inputs(
        4, 64, "float32", "float32", "none"))
    if bad == "accum-bf16":
        accum = accum.to(torch.bfloat16)
    elif bad == "tokens-int64":
        tokens = tokens.long()
    elif bad == "param-f16":
        param = param.half()
    elif bad == "shape":
        buffer = buffer[:, :63]
    else:
        buffer, tokens = buffer[:0], tokens[:0]
    with pytest.raises((TypeError, ValueError)):
        gba_apply(param, accum, buffer, tokens, STEP, LR, iota=IOTA)


def test_push_and_maybe_apply_matches_jax():
    """Three pushes into an M = 3 flat buffer: params untouched until the
    third, which applies with the weights of the step before the push."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((33, 9)).astype(np.float32),
            "b": {"c": rng.standard_normal(41).astype(np.float32)}}
    m, tokens = 3, [0, 4, -3]
    grads = [rng.standard_normal(33 * 9 + 41).astype(np.float32)
             for _ in range(m)]
    jlayout, jbuf = jax_init_flat_buffer(
        {k: jnp.asarray(v) if k == "w" else {"c": jnp.asarray(v["c"])}
         for k, v in tree.items()}, m)
    layout, buf = init_flat_buffer(params_from_jax(tree, device="cpu"), m)
    jp = jnp.asarray(np.concatenate([tree["b"]["c"], tree["w"].ravel()]))
    ja = jnp.full((layout.total,), 0.1, jnp.float32)
    tp, ta = torch.from_numpy(np.array(jp)), torch.full((layout.total,), 0.1)
    for i in range(m):
        before = tp.clone()
        jp, ja, japplied, jbuf = jax_push_apply(
            jbuf, jnp.asarray(grads[i]), jnp.int32(tokens[i]), jp, ja, 0.05,
            iota=2)
        tp, ta, applied, buf = flat_buffer_push_and_maybe_apply(
            buf, torch.from_numpy(grads[i]), tokens[i], tp, ta, 0.05, iota=2)
        assert applied == bool(japplied) == (i == m - 1)
        assert buf["fill"] == int(jbuf["fill"]) == i + 1
        assert buf["step"] == int(jbuf["step"])
        if not applied:
            assert torch.equal(tp, before)
    np.testing.assert_array_equal(buf["tokens"].numpy(),
                                  np.asarray(jbuf["tokens"]))
    np.testing.assert_array_equal(buf["grads"].numpy(),
                                  np.asarray(jbuf["grads"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-7)
