"""The port's gba_aggregate and gba_aggregate_tree on the CPU against the
JAX package's Pallas kernel and tree helper.

The same buffers and tokens, made with numpy from a seed, go through the
JAX package's Pallas ``gba_aggregate`` in interpret mode and through the
port's wrapper on CPU tensors (its plain version, ``gba_aggregate_ref``).

The two agree bit for bit, in float32 and in bfloat16, up to M = 16:
XLA computes the kernel's weighted sum of the M slots one slot after
another with a fused multiply-add from +0.0, with ``w = keep / M``, and
rounds once to the buffer's dtype; the plain version rounds each of those
once too (``kernels.ref.fma_f32``).  The tree helper is held to JAX's
``ops.gba_aggregate_tree`` bit for bit, and at M = 4, where ``1 / M`` is
exact, to the port's ``aggregate_dense`` bit for bit as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.gba_aggregate import gba_aggregate as jax_gba_aggregate
from repro_torch.core.gba import aggregate_dense
from repro_torch.kernels import ops
from repro_torch.kernels.gba_aggregate import gba_aggregate
from repro_torch.kernels.ref import fma_f32, gba_aggregate_ref

STEP, IOTA = 10, 3


def _inputs(m, d, dtype, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, d)).astype(np.float32)
    if dtype == "bfloat16":
        g = g.astype(jnp.bfloat16)
    tokens = rng.integers(0, 12, size=m).astype(np.int32)
    return g, tokens


def _jax(g, tokens, step=STEP, iota=IOTA):
    out = jax_gba_aggregate(jnp.asarray(g), jnp.asarray(tokens),
                            jnp.int32(step), iota=iota, interpret=True)
    return np.asarray(out).astype(np.float32)


def _port(g, tokens, step=STEP, iota=IOTA):
    t = torch.from_numpy(np.asarray(g).astype(np.float32))
    if np.asarray(g).dtype != np.float32:
        t = t.to(torch.bfloat16)
    out = gba_aggregate(t, torch.from_numpy(tokens), step, iota=iota)
    assert out.dtype == t.dtype and out.shape == (t.shape[1],)
    return out.float().numpy()


@pytest.mark.parametrize("m,d", [(4, 100), (8, 2048), (16, 5000), (100, 97),
                                 (3, 5000), (1, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel_bit_for_bit(m, d, dtype):
    """Bit for bit up to M = 16.  At M = 100 XLA adds the slots in an order
    of its own (no sequential, lane-interleaved, chunked or pairwise order
    reproduces it): in float32 the two are held within 1e-6 of the largest
    magnitude (1.0e-7 measured); in bfloat16 the one rounding at the end
    hides the difference."""
    g, tokens = _inputs(m, d, dtype, seed=m * 1000 + d)
    want, got = _jax(g, tokens), _port(g, tokens)
    if m == 100 and dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert np.abs(got).max() > 0 or not ((STEP - tokens) <= IOTA).any()


def test_every_slot_dropped_gives_zero_as_the_kernel_does():
    g, _ = _inputs(4, 300, "float32", seed=1)
    tokens = np.zeros(4, np.int32)
    want, got = _jax(g, tokens, step=100), _port(g, tokens, step=100)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got.any()


def test_products_are_fused_into_the_sum():
    """At M = 3 the same sum with each product rounded on its own differs
    from the kernel on many columns: the plain version fuses them."""
    m, d = 3, 5000
    g, _ = _inputs(m, d, "float32", seed=7)
    tokens = np.full(m, STEP, np.int32)
    got = _port(g, tokens)
    w = np.float32(1) / np.float32(m)
    separate = (g[0] * w + g[1] * w) + g[2] * w
    assert (separate.view(np.uint32) != got.view(np.uint32)).sum() > d // 20
    tg = torch.from_numpy(g)
    fused = fma_f32(tg[2], torch.tensor(w), fma_f32(tg[1], torch.tensor(w),
                                                    tg[0] * w))
    assert torch.equal(fused, torch.from_numpy(got))


@pytest.mark.parametrize("bad", ["tokens-int64", "grads-f16", "grads-1d",
                                 "tokens-shape", "no-slots", "meta"])
def test_rejects_what_the_kernel_does_not_take(bad):
    g, tokens = (torch.from_numpy(x) for x in _inputs(4, 64, "float32", 0))
    if bad == "tokens-int64":
        tokens = tokens.long()
    elif bad == "grads-f16":
        g = g.half()
    elif bad == "grads-1d":
        g = g[0]
    elif bad == "tokens-shape":
        tokens = tokens[:3]
    elif bad == "no-slots":
        g, tokens = g[:0], tokens[:0]
    else:                              # neither CPU nor CUDA: no fallback
        g, tokens = g.to("meta"), tokens.to("meta")
    with pytest.raises((TypeError, ValueError)):
        gba_aggregate(g, tokens, STEP, iota=IOTA)


def _tree(m, dtype, seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((m, 16, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((m, 30)).astype(np.float32),
                  "s": rng.standard_normal((m,)).astype(np.float32)}}
    if dtype == "bfloat16":
        tree = {"a": tree["a"].astype(jnp.bfloat16),
                "b": {k: v.astype(jnp.bfloat16)
                      for k, v in tree["b"].items()}}
    tokens = rng.integers(0, 6, size=m).astype(np.int32)
    return tree, tokens


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    t = torch.from_numpy(np.asarray(x).astype(np.float32))
    return t if np.asarray(x).dtype == np.float32 else t.to(torch.bfloat16)


@pytest.mark.parametrize("m", [8, 4, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_helper_matches_jax_tree_helper(m, dtype):
    tree, tokens = _tree(m, dtype, seed=m)
    want = jax_ops.gba_aggregate_tree(
        {"a": jnp.asarray(tree["a"]),
         "b": {k: jnp.asarray(v) for k, v in tree["b"].items()}},
        jnp.asarray(tokens), jnp.int32(5), iota=2, interpret=True)
    got = ops.gba_aggregate_tree(_to_torch(tree), torch.from_numpy(tokens),
                                 5, iota=2)
    for path in (("a",), ("b", "c"), ("b", "s")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        w = np.asarray(w).astype(np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g.float().numpy().view(np.uint32),
                                      w.view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_helper_equals_aggregate_dense_at_m4(dtype):
    """At M = 4 the weights 0 or 1/4 make every product exact, so the
    kernel's fused order and ``aggregate_dense``'s sum-then-divide agree
    bit for bit."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((4, 33, 7), generator=gen).to(dtype),
            "b": {"c": torch.randn((4, 129), generator=gen).to(dtype)}}
    tokens = torch.tensor([5, 0, 4, 5], dtype=torch.int32)
    got = ops.gba_aggregate_tree(tree, tokens, 5, iota=2)
    want = aggregate_dense(tree, tokens, 5, 2)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for g, w in ((got["w"], want["w"]), (got["b"]["c"], want["b"]["c"])):
        assert g.dtype == dtype and torch.equal(g.view(bits), w.view(bits))
    assert gba_aggregate_ref(tree["w"].reshape(4, -1), tokens, 5, iota=2
                             ).dtype == dtype
