"""The port's GBA core on the CPU against the JAX package: the token list,
the three decay strategies, the pytree aggregation (dense and per-ID
embedding) and the pytree buffer, on the same numpy inputs.

Tolerances: tokens, the threshold weights, ``aggregate_dense`` and the
buffer's tokens, fill and step are exact, the aggregate bit for bit at M =
3, 4, 5 and 16 (XLA adds the slots' products one after another from +0.0
and divides by M; ``torch.sum`` would add in another order).  The smooth
decays and ``aggregate_embedding`` are held within rtol 1e-6: float32
operations that XLA may fuse or reorder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gba as jgba
from repro.core import staleness as jstaleness
from repro.core import tokens as jtokens
from repro_torch.core import gba, staleness, tokens


def test_token_list_construction():
    tl = tokens.token_list(10, 3)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(),
                                  np.asarray(jtokens.token_list(10, 3)))
    assert tl.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3]
    for q, m in ((10, 3), (12, 4), (1, 5)):
        assert tokens.num_global_steps(q, m) == jtokens.num_global_steps(q,
                                                                          m)
    assert tokens.token_for_batch(7, 3) == jtokens.token_for_batch(7, 3) == 2
    np.testing.assert_array_equal(
        tokens.token_for_batch(np.arange(9), 4),
        np.asarray(jtokens.token_for_batch(jnp.arange(9), 4)))


def test_token_list_stateful_and_exhaustion_is_an_index_error():
    mine, ref = tokens.TokenList(6, 2), jtokens.TokenList(6, 2)
    assert [mine.fetch() for _ in range(6)] == [ref.fetch()
                                                for _ in range(6)]
    assert mine.remaining == ref.remaining == 0
    with pytest.raises(tokens.TokenListExhausted):
        mine.fetch()
    assert issubclass(tokens.TokenListExhausted, IndexError)
    assert not issubclass(tokens.TokenListExhausted, StopIteration)

    def dispatch(tl):        # PEP 479 would turn StopIteration into an error
        while True:
            yield tl.fetch()

    got = []
    try:
        for tok in dispatch(tokens.TokenList(2, 1)):
            got.append(tok)
    except tokens.TokenListExhausted:
        pass
    assert got == [0, 1]


@pytest.mark.parametrize("strategy", ["threshold", "exponential", "linear"])
@pytest.mark.parametrize("iota", [0, 2, 5])
def test_decay_weights_match_jax(strategy, iota):
    toks = np.array([0, 1, 2, 3, 4, 7, 9, 12, 15], np.int32)
    for step in (4, 9, 12):
        want = np.asarray(jgba.decay_weights(jnp.asarray(toks),
                                             jnp.int32(step), iota,
                                             strategy))
        got = gba.decay_weights(torch.from_numpy(toks), step, iota,
                                strategy)
        assert got.dtype == torch.float32
        if strategy == "threshold":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert set(staleness.DECAY_FNS) == set(jstaleness.DECAY_FNS)


def test_aggregate_dense_divides_by_m():
    grads = {"w": torch.stack([torch.ones(4), 3 * torch.ones(4)])}
    out = gba.aggregate_dense(grads, torch.tensor([0, 10], dtype=torch.int32),
                              10, 1)
    assert torch.equal(out["w"], torch.full((4,), 1.5))


def _stacked(m, dtype, seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((m, 16, 4)).astype(np.float32),
            "b": {"c": (rng.standard_normal((m, 997)) * 1e-3).astype(
                np.float32)}}
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree)
    toks = rng.integers(0, 8, size=m).astype(np.int32)
    return tree, toks


def _to_torch(tree):
    return jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x).astype(np.float32)).to(
            torch.bfloat16 if np.asarray(x).dtype != np.float32 else
            torch.float32), tree)


@pytest.mark.parametrize("m", [3, 4, 5, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_dense_matches_jax_bit_for_bit(m, dtype):
    tree, toks = _stacked(m, dtype, seed=m)
    want = jgba.aggregate_dense(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(toks), jnp.int32(7), 3)
    got = gba.aggregate_dense(_to_torch(tree), torch.from_numpy(toks), 7, 3)
    for path in (("a",), ("b", "c")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(
            g.float().numpy().view(np.uint32),
            np.asarray(w).astype(np.float32).view(np.uint32))


def _embedding(*args, **kw):
    """Both packages on the same numpy arguments -> (port, jax) pairs."""
    got = gba.aggregate_embedding(
        *(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
          else a for a in args),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    want = jgba.aggregate_embedding(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    return [(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]


def test_aggregate_embedding_rescues_a_stale_slot_per_id():
    """Slot 1 is 10 steps stale: id 2, untouched since step 0, is rescued;
    id 1, updated at step 5, is dropped."""
    (dense, jdense), (counts, jcounts) = _embedding(
        np.array([[0, 1], [1, 2]], np.int32), np.ones((2, 2, 3), np.float32),
        np.array([10, 0], np.int32), np.array([0, 5, 0, 0], np.int32), 10,
        2, 4)
    np.testing.assert_array_equal(counts, [1, 1, 1, 0])
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(dense, jdense)
    np.testing.assert_array_equal(dense[3], np.zeros(3))


def test_aggregate_embedding_padded_ids_and_valid_mask():
    """-1 and ids >= capacity are padding, the valid mask drops an
    in-range entry, and the divisor counts real contributors only."""
    cap = 4
    ids = np.array([[0, cap, 2], [0, -1, 2]], np.int32)
    rows = np.arange(18, dtype=np.float32).reshape(2, 3, 3)
    toks = np.array([5, 5], np.int32)
    last = np.zeros((cap,), np.int32)
    for valid in (None, np.array([[True, True, False], [True, True, True]])):
        kw = {} if valid is None else {"valid": valid}
        (dense, jdense), (counts, jcounts) = _embedding(
            ids, rows, toks, last, 5, 1, cap, **kw)
        np.testing.assert_array_equal(counts, jcounts)
        np.testing.assert_array_equal(dense, jdense)
        assert counts[0] == 2 and counts[1] == counts[3] == 0
        assert counts[2] == (2 if valid is None else 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_embedding_matches_jax_on_random_slots(seed):
    rng = np.random.default_rng(seed)
    m, n, d, cap = 4, 64, 8, 50
    ids = rng.integers(-3, cap + 3, size=(m, n)).astype(np.int32)
    rows = rng.standard_normal((m, n, d)).astype(np.float32)
    toks = rng.integers(0, 10, size=m).astype(np.int32)
    last = rng.integers(0, 10, size=cap).astype(np.int32)
    valid = rng.random((m, n)) > 0.1
    (dense, jdense), (counts, jcounts) = _embedding(
        ids, rows, toks, last, 9, 2, cap, valid=valid)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(dense, jdense, rtol=1e-6, atol=1e-7)
    assert counts.sum() > 0 and (counts < ((ids >= 0) & (ids < cap)
                                           ).sum()).all()


@pytest.mark.parametrize("m", [3, 4])
def test_buffer_push_and_maybe_apply_matches_jax(m):
    """2M pushes into an M-slot buffer with a stale slot in each global
    step: applies at pushes M and 2M, with the aggregate of the step before
    the push; tokens, fill and step as the reference's.  Inside its
    ``lax.cond`` XLA compiles the division by M as a product by f32(1/M):
    at M = 4 that is exact and the aggregates agree bit for bit; at M = 3
    they are held within one float32 ulp (rtol 2**-23)."""
    rng = np.random.default_rng(4)
    params = {"w": np.zeros((4, 3), np.float32),
              "b": {"c": np.zeros((5,), np.float32)}}
    pushes = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(2 * m)]
    toks = [i // m for i in range(2 * m)]
    toks[m - 1] = toks[m + 1] = -9
    jbuf = jgba.init_buffer(jax.tree.map(jnp.asarray, params), m)
    buf = gba.init_buffer(_to_torch(params), m)
    assert buf["grads"]["w"].shape == (m, 4, 3) and buf["fill"] == 0

    def jnoop():
        return (jnp.int32(0), jax.tree.map(jnp.zeros_like,
                                           jax.tree.map(jnp.asarray,
                                                        params)))
    got_applies, want_applies = [], []
    for i, (g, t) in enumerate(zip(pushes, toks)):
        (flag, agg), jbuf = jgba.buffer_push_and_maybe_apply(
            jbuf, jax.tree.map(jnp.asarray, g), jnp.int32(t), 1,
            lambda a: (jnp.int32(1), a), jnoop)
        out, buf = gba.buffer_push_and_maybe_apply(
            buf, _to_torch(g), t, 1, lambda a: a, lambda: None)
        assert (out is not None) == bool(flag) == (i % m == m - 1)
        assert buf["fill"] == int(jbuf["fill"]) == i + 1
        assert buf["step"] == int(jbuf["step"])
        np.testing.assert_array_equal(buf["tokens"].numpy(),
                                      np.asarray(jbuf["tokens"]))
        if out is not None:
            got_applies.append(out)
            want_applies.append(agg)
    assert buf["step"] == 2 and len(got_applies) == 2
    for got, want in zip(got_applies, want_applies):
        for path in (("w",), ("b", "c")):
            g, w = got, want
            for k in path:
                g, w = g[k], w[k]
            if m == 4:
                np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                              np.asarray(w).view(np.uint32))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=2.0**-23, atol=0)
    np.testing.assert_array_equal(buf["grads"]["w"].numpy(),
                                  np.asarray(jbuf["grads"]["w"]))
