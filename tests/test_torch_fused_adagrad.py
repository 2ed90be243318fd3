"""The port's fused_adagrad and adagrad_apply_tree on the CPU against the
JAX package's Pallas kernel and tree helper.

The same param, gradient and accumulator, made with numpy from a seed, go
through the JAX package's Pallas ``fused_adagrad`` in interpret mode and
through the port's wrapper on CPU tensors (its plain version,
``fused_adagrad_ref``).

The two agree bit for bit, in float32 and in bfloat16: XLA computes the
kernel's ``accum + g * g`` as one fused multiply-add, and the plain
version rounds it once too (``kernels.ref.fma_f32``) and takes the square
root correctly rounded.  The tree helper is held to JAX's
``ops.adagrad_apply_tree`` bit for bit, and to the port's
``optim.adagrad``, which rounds ``a + g * g`` and the root on their own,
within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.fused_adagrad import fused_adagrad as jax_fused_adagrad
from repro_torch.kernels import ops
from repro_torch.kernels.fused_adagrad import fused_adagrad
from repro_torch.kernels.ref import fused_adagrad_ref
from repro_torch.optim import adagrad

LR = 0.01


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    a = np.abs(rng.standard_normal(n)).astype(np.float32)
    if dtype == "bfloat16":
        p, g = p.astype(jnp.bfloat16), g.astype(jnp.bfloat16)
    return p, g, a


def _torch(x):
    t = torch.from_numpy(np.asarray(x).astype(np.float32))
    return t if np.asarray(x).dtype == np.float32 else t.to(torch.bfloat16)


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [100, 4096, 4097, 20_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel_bit_for_bit(n, dtype):
    p, g, a = _inputs(n, dtype, seed=n)
    jp, ja = jax_fused_adagrad(jnp.asarray(p), jnp.asarray(g),
                               jnp.asarray(a), LR, interpret=True)
    tp, tg, ta = _torch(p), _torch(g), _torch(a)
    out_p, out_a = fused_adagrad(tp, tg, ta, LR)
    assert out_p is tp and out_a is ta and tp.dtype == _torch(p).dtype
    np.testing.assert_array_equal(_bits(tp.float()), _bits(jp))
    np.testing.assert_array_equal(_bits(ta), _bits(ja))
    assert (ta > torch.from_numpy(a)).float().mean() > 0.9


def test_mixed_dtypes_match_the_kernel():
    """bfloat16 param with a float32 gradient, and the reverse."""
    p, g, a = _inputs(5000, "float32", seed=3)
    for pd, gd in ((jnp.bfloat16, jnp.float32), (jnp.float32, jnp.bfloat16)):
        pp, gg = p.astype(pd), g.astype(gd)
        jp, ja = jax_fused_adagrad(jnp.asarray(pp), jnp.asarray(gg),
                                   jnp.asarray(a), LR, interpret=True)
        tp, ta = _torch(pp), _torch(a)
        fused_adagrad(tp, _torch(gg), ta, LR)
        np.testing.assert_array_equal(_bits(tp.float()), _bits(jp))
        np.testing.assert_array_equal(_bits(ta), _bits(ja))


def test_the_accumulator_is_one_fused_multiply_add():
    """``a + g * g`` rounded twice differs from the kernel's on many
    elements; the plain version's single rounding does not."""
    p, g, a = (torch.from_numpy(x) for x in _inputs(20_000, "float32", 9))
    _, got = fused_adagrad_ref(p, g, a, LR)
    assert (got != a + g * g).sum() > 1000


@pytest.mark.parametrize("bad", ["accum-bf16", "param-f16", "grad-shape",
                                 "param-2d", "meta"])
def test_rejects_what_the_kernel_does_not_take(bad):
    p, g, a = (torch.from_numpy(x) for x in _inputs(64, "float32", 0))
    if bad == "accum-bf16":
        a = a.bfloat16()
    elif bad == "param-f16":
        p = p.half()
    elif bad == "grad-shape":
        g = g[:63]
    elif bad == "param-2d":
        p, g, a = p.reshape(8, 8), g.reshape(8, 8), a.reshape(8, 8)
    else:                              # neither CPU nor CUDA: no fallback
        p, g, a = p.to("meta"), g.to("meta"), a.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fused_adagrad(p, g, a, LR)


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (33, 9), "b": {"c": (41,), "s": ()}}

    def draw(s, scale=1.0, pos=False):
        if isinstance(s, dict):
            return {k: draw(v, scale, pos) for k, v in s.items()}
        x = rng.standard_normal(s) * scale
        return np.array(np.abs(x) + 0.1 if pos else x, np.float32)
    return (draw(shapes), draw(shapes, 0.1), draw(shapes, pos=True))


def _map(fn, t):
    return {k: _map(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def test_tree_helper_matches_jax_and_leaves_its_inputs_alone():
    params, grads, accums = _tree(1)
    jp, ja = jax_ops.adagrad_apply_tree(
        *(_map(jnp.asarray, t) for t in (params, grads, accums)), LR,
        interpret=True)
    tp, tg, ta = (_map(torch.from_numpy, t) for t in (params, grads,
                                                      accums))
    before = [_map(torch.clone, t) for t in (tp, tg, ta)]
    calls = ops.kernel_calls.copy()
    new_p, new_a = ops.adagrad_apply_tree(tp, tg, ta, LR)
    assert ops.kernel_calls == calls
    for path in (("w",), ("b", "c"), ("b", "s")):
        got, want = [new_p, new_a], [jp, ja]
        for k in path:
            got, want = [x[k] for x in got], [x[k] for x in want]
        for g, w in zip(got, want):
            assert g.shape == np.asarray(w).shape, path
            np.testing.assert_array_equal(_bits(g), _bits(w))
    # the caller's trees are untouched: the kernel updates clones
    for t, b in zip((tp, tg, ta), before):
        for x, y in zip(jax.tree.leaves(_map(lambda v: v.numpy(), t)),
                        jax.tree.leaves(_map(lambda v: v.numpy(), b))):
            np.testing.assert_array_equal(x, y)


def test_tree_helper_is_the_optimizer_within_rounding():
    params, grads, accums = (_map(torch.from_numpy, t) for t in _tree(2))
    new_p, new_a = ops.adagrad_apply_tree(params, grads, accums, LR)
    opt = adagrad(LR)
    want_p, want_s = opt.update(params, grads, {"accum": accums})
    for got, want in ((new_p, want_p), (new_a, want_s["accum"])):
        for k in ("w",):
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)
        torch.testing.assert_close(got["b"]["c"], want["b"]["c"], rtol=1e-6,
                                   atol=0)
