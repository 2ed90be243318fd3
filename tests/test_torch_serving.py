"""The port's recsys scoring path on the CPU, against the JAX package.

* The same numpy parameters go through ``params_from_jax`` into the port's
  engine and into the JAX engine: the same raw ids give bit-identical
  pooled vectors, and scores within rtol=1e-6, atol=1e-7 (the two towers
  run their float32 matmuls in different orders).
* The recsys properties of ``tests/test_serving_live.py`` hold on the port:
  live = fresh at every sync, exact touched-row invalidation, an all-hit
  batch skips the kernel, channel coalescing, stale put and LRU eviction,
  and a clean thread shutdown.
* ``hash_ids`` and the npz checkpoint layout agree across the packages.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
import repro.embeddings.hot_cache as jax_cache
import repro.serving as jax_serving
from repro.embeddings.table import hash_ids as jax_hash_ids
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.embeddings import HotIDCache, cached_pooled_lookup, hash_ids
from repro_torch.kernels import ops
from repro_torch.serving import (LiveSource, RecsysScoringEngine,
                                 ServingConfig, StaticSource, UpdateChannel,
                                 init_scoring_params)

V, DIM = 4096, 16
SCFG = ServingConfig(cache_capacity=128)
CPU = "cpu"

RAW_IDS = [0, 1, -1, -7, 2**31 - 1, 2**31 + 5, 2**40 + 3]
HASHED_1M = [0, 368889, 408326, 303852, 796934, 901408, 329453]


def _ids(rng, B=4, F=8, hi=256):
    return rng.integers(0, hi, size=(B, F))


def _port_params(seed=0):
    return init_scoring_params(V, DIM, generator=torch.Generator()
                               .manual_seed(seed), device=CPU)


def _engine(source, config=SCFG):
    return RecsysScoringEngine(source, config=config, device=CPU)


def _hashed(raw, capacity=V):
    return hash_ids(torch.from_numpy(np.asarray(raw)), capacity).numpy()


@pytest.fixture(scope="module")
def jax_world():
    """JAX params as numpy, and the JAX engine's scores of three batches."""
    params = jax.tree.map(np.asarray, jax_serving.init_scoring_params(
        jax.random.PRNGKey(0), V, DIM))
    eng = jax_serving.RecsysScoringEngine(params, config=jax_serving
                                          .ServingConfig(cache_capacity=128))
    rng = np.random.default_rng(0)
    batches = [_ids(rng) for _ in range(3)]
    scores = [eng.score(b) for b in batches]
    return params, batches, scores


def test_engine_matches_jax_engine(jax_world):
    params, batches, want = jax_world
    eng = _engine(StaticSource(params_from_jax(params, device=CPU)))
    for batch, w in zip(batches, want):
        np.testing.assert_allclose(eng.score(batch), w, rtol=1e-6, atol=1e-7)
    assert eng.cache.hits > 0


def test_pooled_vectors_bit_identical_to_jax(jax_world):
    params, batches, _ = jax_world
    port = params_from_jax(params, device=CPU)
    jcache, pcache = jax_cache.HotIDCache(64, DIM), HotIDCache(64, DIM)
    jtable = jax.tree.map(jnp.asarray, params["table"])
    for batch in batches:
        hashed = _hashed(batch)
        np.testing.assert_array_equal(
            hashed, np.asarray(jax_hash_ids(jnp.asarray(batch, jnp.int32),
                                            V)))
        want = jax_cache.cached_pooled_lookup(jcache, jtable, hashed)
        got = cached_pooled_lookup(pcache, port["table"], hashed)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            cached_pooled_lookup(None, port["table"], hashed), want)


def test_hash_ids_matches_jax():
    raw = np.asarray(RAW_IDS, np.int64)
    np.testing.assert_array_equal(_hashed(raw, 1_000_000), HASHED_1M)
    jax_hashed = jax_hash_ids(jnp.asarray(raw.astype(np.int32)), 1_000_000)
    np.testing.assert_array_equal(np.asarray(jax_hashed), HASHED_1M)


def test_jax_checkpoint_loads_and_scores_the_same(jax_world, tmp_path):
    params, batches, want = jax_world
    jax_ckpt.save_pytree(str(tmp_path / "ckpt_00000005.npz"), params)
    src = StaticSource.from_checkpoint(str(tmp_path), device=CPU)
    assert src.snapshot().step == 5
    eng = _engine(src)
    ref = _engine(StaticSource(params_from_jax(params, device=CPU)))
    for batch, w in zip(batches, want):
        got = eng.score(batch)
        np.testing.assert_array_equal(got, ref.score(batch))
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7)


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    params = _port_params()
    params["mlp"]["w0"] = params["mlp"]["w0"].to(torch.bfloat16)
    path = str(tmp_path / "p.npz")
    save_pytree(path, params)
    back = jax_ckpt.load_pytree(path)
    assert str(back["mlp"]["w0"].dtype) == "bfloat16"
    assert str(back["table"][1].dtype) == "int32"
    want = params_to_numpy(params)
    np.testing.assert_array_equal(np.asarray(back["table"][0]),
                                  want["table"].table)
    for k in want["mlp"]:
        np.testing.assert_array_equal(
            np.asarray(back["mlp"][k], np.float32), want["mlp"][k])
    mine = load_pytree(path)
    assert mine["mlp"]["w0"].dtype == torch.bfloat16
    assert torch.equal(mine["mlp"]["w0"], params["mlp"]["w0"])
    assert torch.equal(mine["table"][0], params["table"].table)


# -- the recsys properties of tests/test_serving_live.py, on the port ------

def test_live_matches_fresh_at_every_sync_boundary():
    params = _port_params()
    chan = UpdateChannel()
    live = LiveSource(chan, params, start=False)
    eng = _engine(live)
    rng = np.random.default_rng(0)
    eng.score(_ids(rng))                      # warm some cache entries
    table = params["table"]
    for step in range(1, 4):
        touch = _hashed(rng.integers(0, 256, 8))
        new = table.table.clone()
        new.index_put_((torch.from_numpy(touch).long(),), torch.tensor(0.5),
                       accumulate=True)
        table = table._replace(table=new)
        chan.publish({"table": table, "mlp": params["mlp"]}, step,
                     touched_ids=touch)
        snap = live.sync_now()
        assert snap.version == step + 1
        fresh = _engine(StaticSource(snap.params))
        batch = _ids(rng)
        np.testing.assert_array_equal(eng.score(batch), fresh.score(batch))
    assert eng.stats()["syncs_adopted"] == 3
    assert eng.cache.hits > 0                 # the mix really had hits


def test_touched_row_invalidation_is_exact():
    params = _port_params()
    chan = UpdateChannel()
    live = LiveSource(chan, params, start=False)
    eng = _engine(live)
    batch = np.arange(32).reshape(4, 8)
    eng.score(batch)                          # all unique rows now cached
    touch = _hashed(np.arange(8))             # touches half of bag 0
    new_table = params["table"]._replace(
        table=params["table"].table.index_add(
            0, torch.from_numpy(touch).long(),
            torch.ones((touch.size, DIM))))
    chan.publish({"table": new_table, "mlp": params["mlp"]}, 1,
                 touched_ids=touch)
    live.sync_now()
    expected_refetch = np.intersect1d(np.unique(_hashed(batch)), touch).size
    m0 = eng.cache.misses
    got = eng.score(batch)
    assert eng.cache.misses - m0 == expected_refetch
    fresh = _engine(StaticSource({"table": new_table, "mlp": params["mlp"]}))
    np.testing.assert_array_equal(got, fresh.score(batch))


def test_all_hit_batch_skips_kernel():
    eng = _engine(StaticSource(_port_params()))
    batch = _ids(np.random.default_rng(1))
    eng.score(batch)                          # populates the cache
    before = ops.kernel_calls["pooled_lookup"]
    out_hit = eng.score(batch)
    assert ops.kernel_calls["pooled_lookup"] == before
    # cache disabled: same values, but the kernel wrapper IS invoked
    nocache = _engine(StaticSource(_port_params()),
                      ServingConfig(cache_capacity=0))
    out_miss = nocache.score(batch)
    assert ops.kernel_calls["pooled_lookup"] == before + 1
    np.testing.assert_array_equal(out_hit, out_miss)


def test_channel_coalesces_and_unions_touched():
    chan = UpdateChannel()
    chan.publish("s1", 1, touched_ids=[1, 2])
    chan.publish("s2", 2, touched_ids=[2, 3])
    params, step, touched = chan.take()
    assert params == "s2" and step == 2
    assert sorted(touched.tolist()) == [1, 2, 3]
    assert chan.coalesced == 1
    assert chan.take() is None
    # one publish without touched ids poisons the window to full-clear
    chan.publish("s3", 3, touched_ids=[4])
    chan.publish("s4", 4)
    assert chan.take()[2] is None


def test_stale_put_is_ignored_and_lru_evicts():
    cache = HotIDCache(2, DIM)
    cache.bump_version(2)
    row = np.zeros((1, DIM), np.float32)
    assert not cache.put_many(np.array([1]), row, version=1)
    assert len(cache) == 0
    for i in (1, 2, 3):                       # capacity 2 -> 1 evicted
        assert cache.put_many(np.array([i]), row, version=2)
    assert len(cache) == 2 and cache.evictions == 1
    _, found = cache.get_many(np.array([1, 2, 3]))
    assert found.tolist() == [False, True, True]


def test_score_during_a_sync_never_mixes_versions():
    """A score that lands while a sync is being adopted pools rows of one
    version only.  Every row of version k is k/1000, so a request pooling
    stale cached rows with freshly fetched ones scores unlike any version.
    The score is started from the cache invalidation itself, the moment
    the JAX engine leaves open between its table swap and the bump."""
    def params(k):
        return {"table": params_from_jax(
                    (np.full((V, DIM), k / 1000, np.float32),
                     np.zeros(V, np.int32)), device=CPU),
                "mlp": {"w0": torch.ones((DIM, 1)), "b0": torch.zeros(1)}}

    batch = np.arange(8).reshape(1, 8)
    want = {k: _engine(StaticSource(params(k))).score(batch)[0]
            for k in (0, 1)}
    live = LiveSource(UpdateChannel(), params(0), start=False)
    eng = _engine(live)
    eng.score(batch[:, :4])                   # half the ids cached at v1
    got = []
    bump = eng.cache.bump_version

    def bump_with_a_score_racing(*args):
        racer = threading.Thread(target=lambda: got.append(eng.score(batch)))
        racer.start()
        racer.join(timeout=0.5)               # blocks while the sync holds
        bump(*args)
        threads.append(racer)

    threads = []
    eng.cache.bump_version = bump_with_a_score_racing
    live.channel.publish(params(1), 1, touched_ids=np.arange(V))
    live.sync_now()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(got) == 1
    assert got[0][0] in (want[0], want[1])


def test_live_thread_adopts_and_closes_cleanly():
    params = _port_params()
    chan = UpdateChannel()
    live = LiveSource(chan, params, sync_interval=0.01)  # thread on
    eng = _engine(live)
    new_table = params["table"]._replace(table=params["table"].table + 1.0)
    chan.publish({"table": new_table, "mlp": params["mlp"]}, 5)
    deadline = time.time() + 10.0
    while eng.stats()["param_version"] == 1 and time.time() < deadline:
        time.sleep(0.005)
    assert live.snapshot().version == 2
    assert live.snapshot().step == 5
    assert eng.stats()["param_step"] == 5
    assert live.freshness_lag_steps() == 0
    live.close(grace=5.0)
    assert live.closed
    live.close()                              # idempotent
    assert live.snapshot().version == 2       # still serves last snapshot
