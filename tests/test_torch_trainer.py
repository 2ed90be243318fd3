"""The port's training slice on the CPU against the JAX package.

Parameters are built by the JAX package and carried across with
``params_from_jax``; every other input (click stream, schedules, labels)
is made with numpy from a seed and is identical in both packages.

Tolerances:
* the click stream, the simulator's schedules and AUC are numpy copies and
  must be identical;
* the DeepFM logit and the BCE loss (and its gradient) agree to rtol 1e-5:
  float32 sums in another order;
* optimizer updates agree to rtol 1e-5 / atol 1e-7;
* a replay of the stale GBA schedule under SGD gives parameters within
  rtol 1e-5 / atol 1e-7, with ``last_update`` and ``ReplayStats`` exact;
  under Adam, whose first steps amplify rounding to about +-lr wherever
  |g| >> eps, only the per-step losses are held, to rtol 1e-4; the same
  holds for DIEN and YouTubeDNN at the tiny table and tower;
* ``run_continual`` (one sync day, one GBA day): modes and qps exact,
  stats exact, AUC atol 1e-3, losses rtol 1e-4, for all three models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recsys import ALIMAMA_DIEN as JAX_DIEN
from repro.configs.recsys import CRITEO_DEEPFM as JAX_DEEPFM
from repro.configs.recsys import PRIVATE_YOUTUBEDNN as JAX_YOUTUBEDNN
from repro.core import GBATrainer as JaxTrainer
from repro.core import default_setups as jax_default_setups
from repro.core import run_continual as jax_run_continual
from repro.data import make_clickstream as jax_make_clickstream
from repro.embeddings import StreamConfig
from repro.metrics import StreamingAUC as JaxStreamingAUC
from repro.metrics import auc as jax_auc
from repro.models import recsys as JR
from repro.optim import get_optimizer as jax_get_optimizer
from repro.sim.cluster import ClusterSpec as JaxClusterSpec
from repro.sim.cluster import Schedule as JaxSchedule
from repro.sim.cluster import Slot as JaxSlot
from repro.sim.cluster import simulate as jax_simulate
from repro_torch.configs.recsys import (ALIMAMA_DIEN, CRITEO_DEEPFM,
                                        PRIVATE_YOUTUBEDNN)
from repro_torch.convert import (jax_init_recsys, params_from_jax,
                                 params_to_numpy)
from repro_torch.core import (GBATrainer, default_setups, pretrain_sync,
                              run_continual)
from repro_torch.data import make_clickstream
from repro_torch.embeddings.table import EmbeddingTable
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag_grad
from repro_torch.kernels.ref import embedding_bag_grad_ref, embedding_bag_ref
from repro_torch.launch import quickstart, train
from repro_torch.metrics import StreamingAUC, auc
from repro_torch.models import recsys as R
from repro_torch.optim import get_optimizer
from repro_torch.sim.cluster import ClusterSpec, Schedule, Slot, simulate

# the tiny config of repro's tests/test_trainer.py
JCFG = dataclasses.replace(JAX_DEEPFM, name="criteo-deepfm-tiny",
                           hash_capacity=2048, mlp_dims=(32, 16))
CFG = dataclasses.replace(CRITEO_DEEPFM, name="criteo-deepfm-tiny",
                          hash_capacity=2048, mlp_dims=(32, 16))
# the behaviour-sequence models at the same tiny table and tower
TINY = {model: tuple(dataclasses.replace(c, name=f"{c.name}-tiny",
                                         hash_capacity=2048,
                                         mlp_dims=(32, 16))
                     for c in pair)
        for model, pair in (("dien", (JAX_DIEN, ALIMAMA_DIEN)),
                            ("youtubednn", (JAX_YOUTUBEDNN,
                                            PRIVATE_YOUTUBEDNN)))}


@pytest.fixture
def one_torch_thread():
    """The behaviour models' replays run thousands of tiny operators: one
    intra-op thread keeps them from contending with the suite's other
    workers (an oversubscribed thread pool slowed them 100-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(seed=2, cfg=JCFG):
    return JR.init_recsys(jax.random.PRNGKey(seed), cfg)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_tree_close(port_tree, jax_tree, rtol, atol):
    got = dict(_leaves(params_to_numpy(port_tree)))
    want = dict(_leaves(_numpy(jax_tree)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# numpy copies: identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["deepfm", "dien"])
def test_clickstream_batches_are_identical(which):
    jcfg, cfg = ((JAX_DEEPFM, CRITEO_DEEPFM) if which == "deepfm"
                 else (JAX_DIEN, ALIMAMA_DIEN))
    js = jax_make_clickstream(jcfg, seed=3, batch_size=16)
    ts = make_clickstream(cfg, seed=3, batch_size=16)
    for day, index in ((0, 0), (2, 7), (5, 10_001)):
        jb, tb = js.batch(day, index), ts.batch(day, index)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["sync", "async", "bsp", "hop_bs", "hop_bw",
                                  "gba"])
def test_simulated_schedules_are_identical(mode):
    kw = dict(num_workers=8, straggler_frac=0.25, straggler_slowdown=5.0,
              jitter=0.2, time_varying=True, ps_throughput=2000.0,
              failure_rate=0.02, seed=4)
    args = dict(buffer_size=4, iota=2, b1=2, b2=4, b3=2)
    js = jax_simulate(JaxClusterSpec(**kw), mode, 96, 64, **args)
    ts = simulate(ClusterSpec(**kw), mode, 96, 64, **args)
    assert ts.mode == js.mode and ts.local_batch == js.local_batch
    assert [[dataclasses.astuple(s) for s in step] for step in ts.steps] == \
        [[dataclasses.astuple(s) for s in step] for step in js.steps]
    assert dataclasses.asdict(ts.metrics) == dataclasses.asdict(js.metrics)


def test_auc_is_identical():
    rng = np.random.default_rng(5)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    scores = np.round(rng.standard_normal(500), 1)       # many ties
    assert auc(labels, scores) == jax_auc(labels, scores)
    assert auc(np.ones(4), scores[:4]) == jax_auc(np.ones(4), scores[:4])
    ts, js = StreamingAUC(), JaxStreamingAUC()
    for i in range(0, 500, 100):
        ts.update(labels[i:i + 100], scores[i:i + 100])
        js.update(labels[i:i + 100], scores[i:i + 100])
    assert ts.compute() == js.compute()


# ---------------------------------------------------------------------------
# model and optimizers
# ---------------------------------------------------------------------------

def _batch(cfg, seed=6, bs=32):
    return make_clickstream(cfg, seed=seed, batch_size=bs).batch(0, 3)


def test_deepfm_logit_bce_loss_and_gradient_match_jax():
    jparams = _jax_params()
    batch = _batch(CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = params_from_jax(_numpy(jparams), device="cpu")
    np.testing.assert_allclose(R.deepfm_logit(params, CFG, tb).numpy(),
                               np.asarray(JR.deepfm_logit(jparams, JCFG, jb)),
                               rtol=1e-5, atol=1e-7)
    jloss, jgrad = jax.value_and_grad(JR.bce_loss)(jparams, JCFG, jb)
    grad, loss = torch.func.grad_and_value(R.bce_loss)(params, CFG, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(grad, jgrad, rtol=1e-5, atol=1e-8)


def test_init_recsys_draws_the_reference_tree():
    params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    want = _numpy(_jax_params())
    got = params_to_numpy(params)
    assert {k for k, _ in _leaves(got)} == {k for k, _ in _leaves(want)}
    for k, v in _leaves(want):
        assert dict(_leaves(got))[k].shape == v.shape, k
        assert dict(_leaves(got))[k].dtype == v.dtype, k
    assert params["bias"].dim() == 0
    assert R.sparse_dense_split(params) == ({"embed", "linear"},
                                            {"bias", "mlp"})


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizers_match_jax(name):
    jparams = _jax_params()
    batch = {k: jnp.asarray(v) for k, v in _batch(JCFG).items()}
    jopt = jax_get_optimizer(name, 1e-2)
    opt = get_optimizer(name, 1e-2)
    jstate = jopt.init(jparams)
    params = params_from_jax(_numpy(jparams), device="cpu")
    state = opt.init(params)
    for _ in range(3):
        jgrad = jax.grad(JR.bce_loss)(jparams, JCFG, batch)
        jparams, jstate = jopt.update(jparams, jgrad, jstate)
        params, state = opt.update(
            params, params_from_jax(_numpy(jgrad), device="cpu"), state)
    _assert_tree_close(params, jparams, rtol=1e-5, atol=1e-7)
    if name == "adam":
        assert state["count"].dtype == torch.int32 and state["count"] == 3
    _assert_tree_close({k: v for k, v in state.items() if k != "count"},
                       {k: v for k, v in jstate.items() if k != "count"},
                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_update_leaves_its_inputs_untouched(name):
    params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = get_optimizer(name, 0.1)
    state = opt.init(params)
    grads = R.init_recsys(CFG, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    before = params_to_numpy({"p": params, "s": state})
    before = {k: v.copy() for k, v in _leaves(before)}
    new_params, _ = opt.update(params, grads, state)
    after = dict(_leaves(params_to_numpy({"p": params, "s": state})))
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert not np.array_equal(new_params["embed"].numpy(),
                              params["embed"].numpy())


# ---------------------------------------------------------------------------
# the replay trainer
# ---------------------------------------------------------------------------

def _stale_steps(slot, lagged=False):
    """repro's tests/test_trainer.py:118-120: 4 global steps of 3 slots,
    slot i of step k holding token max(0, k - i) and weight 0 for i = 2.
    ``lagged`` also dispatches each slot at its token's version, so the
    gradients are taken against stale parameters."""
    return [[slot(k * 3 + i, max(0, k - i), max(0, k - i) if lagged else k,
                  1.0 if i < 2 else 0.0) for i in range(3)]
            for k in range(4)]


def _replay_both(optimizer, lr, steps_fn, iota=1, jcfg=JCFG, cfg=CFG):
    jparams = _jax_params(cfg=jcfg)
    jopt = jax_get_optimizer(optimizer, lr)
    jtrainer = JaxTrainer(jcfg, jopt, iota=iota, embed_stream=StreamConfig())
    jout = jtrainer.replay(
        jparams, jopt.init(jparams), JaxSchedule("gba", 32, steps_fn(JaxSlot)),
        jax_make_clickstream(jcfg, seed=0, batches_per_day=16,
                             batch_size=32), day=0)
    opt = get_optimizer(optimizer, lr)
    params = params_from_jax(_numpy(jparams), device="cpu")
    out = GBATrainer(cfg, opt, iota=iota).replay(
        params, opt.init(params), Schedule("gba", 32, steps_fn(Slot)),
        make_clickstream(cfg, seed=0, batches_per_day=16, batch_size=32),
        day=0)
    return out, jout


def _assert_same_stats(st, jst, loss_rtol):
    for name in ("applied_steps", "kept_slots", "dropped_slots",
                 "history_clamps", "embed_rows_rescued"):
        assert getattr(st, name) == getattr(jst, name), name
    np.testing.assert_allclose(st.losses, jst.losses, rtol=loss_rtol)


@pytest.mark.parametrize("lagged", [False, True], ids=["fresh", "lagged"])
def test_stale_schedule_replay_matches_jax_under_sgd(lagged):
    (p, _, lu, st), (jp, _, jlu, jst) = _replay_both(
        "sgd", 0.05, lambda s: _stale_steps(s, lagged))
    assert jst.embed_rows_rescued > 0           # the per-ID rescue ran
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    _assert_same_stats(st, jst, loss_rtol=1e-5)
    _assert_tree_close(p, jp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("lagged", [False, True], ids=["fresh", "lagged"])
def test_stale_schedule_replay_matches_jax_under_adam(lagged):
    (_, state, lu, st), (_, jstate, jlu, jst) = _replay_both(
        "adam", 1e-3, lambda s: _stale_steps(s, lagged))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    _assert_same_stats(st, jst, loss_rtol=1e-4)
    assert int(state["count"]) == int(jstate["count"]) == 4


@pytest.mark.parametrize("model", sorted(TINY))
def test_stale_schedule_replay_of_behaviour_models_matches_jax_under_sgd(
        model, one_torch_thread):
    """DIEN and YouTubeDNN on the lagged stale schedule: the per-slot
    gradients of stacked parameter versions, the behaviour and target ids
    in the presence counts and the per-ID rescue."""
    jcfg, cfg = TINY[model]
    (p, _, lu, st), (jp, _, jlu, jst) = _replay_both(
        "sgd", 0.05, lambda s: _stale_steps(s, lagged=True), jcfg=jcfg,
        cfg=cfg)
    assert jst.embed_rows_rescued > 0
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    _assert_same_stats(st, jst, loss_rtol=1e-5)
    _assert_tree_close(p, jp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("model", sorted(TINY))
def test_stale_schedule_replay_of_behaviour_models_matches_jax_under_adam(
        model, one_torch_thread):
    jcfg, cfg = TINY[model]
    (_, state, lu, st), (_, jstate, jlu, jst) = _replay_both(
        "adam", 1e-3, lambda s: _stale_steps(s, lagged=True), jcfg=jcfg,
        cfg=cfg)
    np.testing.assert_array_equal(lu.numpy(), np.asarray(jlu))
    _assert_same_stats(st, jst, loss_rtol=1e-4)
    assert int(state["count"]) == int(jstate["count"]) == 4


def test_stale_parameter_versions_are_not_aliased():
    """The version ring holds earlier parameters by reference.  Were they
    updated in place, the lagged replay would take every gradient at the
    current parameters and equal the fresh one; it must instead differ
    from it as the JAX package's does."""
    (p_lag, *_), (jp_lag, *_) = _replay_both(
        "sgd", 0.05, lambda s: _stale_steps(s, lagged=True))
    (p_fresh, *_), (jp_fresh, *_) = _replay_both(
        "sgd", 0.05, lambda s: _stale_steps(s, lagged=False))
    lag, fresh = (dict(_leaves(params_to_numpy(p))) for p in (p_lag, p_fresh))
    jlag, jfresh = (dict(_leaves(_numpy(p))) for p in (jp_lag, jp_fresh))
    assert np.abs(jlag["/linear"] - jfresh["/linear"]).max() > 1e-3
    for k in jlag:
        np.testing.assert_allclose(lag[k] - fresh[k], jlag[k] - jfresh[k],
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_gba_with_zero_staleness_equals_sync():
    stream = make_clickstream(CFG, seed=0, batches_per_day=16, batch_size=32)
    opt = get_optimizer("sgd", 0.1)
    steps = [[Slot(k * 4 + i, k, k, 1.0) for i in range(4)] for k in range(4)]
    out = {}
    for mode in ("sync", "gba"):
        params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(1),
                               device="cpu")
        out[mode] = GBATrainer(CFG, opt).replay(
            params, opt.init(params), Schedule(mode, 32, steps), stream, 0)[0]
    for k in ("bias", "embed", "linear"):
        torch.testing.assert_close(out["sync"][k], out["gba"][k], rtol=1e-5,
                                   atol=1e-7)


def test_history_ring_clamps_are_counted():
    stream = make_clickstream(CFG, seed=0, batches_per_day=16, batch_size=32)
    opt = get_optimizer("sgd", 0.1)
    params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    steps = [[Slot(0, 0, 0, 1.0)], [Slot(1, 1, 1, 1.0)],
             [Slot(2, 2, 2, 1.0)], [Slot(3, 3, 0, 1.0)]]
    _, _, _, stats = GBATrainer(CFG, opt, history=2).replay(
        params, opt.init(params), Schedule("gba", 32, steps), stream, 0)
    assert stats.history_clamps == 1


def test_replay_counts_each_global_step_through_one_grad_wrapper_call():
    stream = make_clickstream(CFG, seed=0, batches_per_day=16, batch_size=32)
    opt = get_optimizer("sgd", 0.1)
    params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    calls = ops.kernel_calls["pooled_lookup_grad"]
    launches = embedding_bag_grad.launches
    GBATrainer(CFG, opt).replay(params, opt.init(params),
                                Schedule("gba", 32, _stale_steps(Slot)),
                                stream, 0)
    assert ops.kernel_calls["pooled_lookup_grad"] == calls + 4
    assert embedding_bag_grad.launches == launches       # CPU: no launch


def test_run_continual_matches_jax():
    """One sync day, then one GBA day, at the tiny config."""
    kw = dict(num_workers=16, straggler_frac=0.25, seed=0)
    jstream = jax_make_clickstream(JCFG, seed=0, batches_per_day=8,
                                   batch_size=64)
    stream = make_clickstream(CFG, seed=0, batches_per_day=8, batch_size=64)
    jparams = _jax_params()
    params = params_from_jax(_numpy(jparams), device="cpu")
    jp, jres = jax_run_continual(jparams, JCFG, jstream, ["sync", "gba"],
                                 jax_default_setups(256),
                                 JaxClusterSpec(**kw), eval_batches=2)
    p, res = run_continual(params, CFG, stream, ["sync", "gba"],
                           default_setups(256), ClusterSpec(**kw),
                           eval_batches=2)
    assert res.mode_per_day == jres.mode_per_day
    assert res.qps_per_day == jres.qps_per_day
    np.testing.assert_allclose(res.auc_per_day, jres.auc_per_day, atol=1e-3)
    _assert_same_stats(res.stats, jres.stats, loss_rtol=1e-4)


@pytest.mark.parametrize("model", sorted(TINY))
def test_run_continual_of_behaviour_models_matches_jax(model,
                                                      one_torch_thread):
    """One sync day, then one GBA day, of DIEN and YouTubeDNN at the tiny
    stream, from the reference's draw."""
    jcfg, cfg = TINY[model]
    kw = dict(num_workers=16, straggler_frac=0.25, seed=0)
    jstream = jax_make_clickstream(jcfg, seed=0, batches_per_day=8,
                                   batch_size=64)
    stream = make_clickstream(cfg, seed=0, batches_per_day=8, batch_size=64)
    jparams = _jax_params(seed=0, cfg=jcfg)
    params = jax_init_recsys(cfg, 0, device="cpu")
    jp, jres = jax_run_continual(jparams, jcfg, jstream, ["sync", "gba"],
                                 jax_default_setups(256),
                                 JaxClusterSpec(**kw), eval_batches=2)
    p, res = run_continual(params, cfg, stream, ["sync", "gba"],
                           default_setups(256), ClusterSpec(**kw),
                           eval_batches=2)
    assert res.mode_per_day == jres.mode_per_day
    assert res.qps_per_day == jres.qps_per_day
    np.testing.assert_allclose(res.auc_per_day, jres.auc_per_day, atol=1e-3)
    _assert_same_stats(res.stats, jres.stats, loss_rtol=1e-4)
    assert res.stats.applied_steps == 4


def test_pretrain_sync_runs_on_the_cpu():
    stream = make_clickstream(CFG, seed=0, batches_per_day=4, batch_size=64)
    params = pretrain_sync(torch.Generator().manual_seed(0), CFG, stream,
                           default_setups(256), ClusterSpec(num_workers=8),
                           1, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert all(torch.isfinite(v).all() for _, v in _leaves(params))


# ---------------------------------------------------------------------------
# the entry points, on the CPU at a small size
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu_at_a_small_size():
    params = R.init_recsys(CFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    lines = []
    calls = ops.kernel_calls["pooled_lookup_grad"]
    res = quickstart.run(params, CFG, days=2, log=lines.append)
    assert len(res.rows) == 2 and len(lines) == 3
    steps = sum(r.steps for r in res.rows)
    assert steps == 2 * quickstart.NUM_BATCHES // quickstart.SETUP.buffer_size
    assert ops.kernel_calls["pooled_lookup_grad"] == calls + steps
    for row in res.rows:
        assert 0.0 <= row.auc <= 1.0 and row.stats.applied_steps == row.steps
        assert row.stats.data_s > 0 and row.stats.step_s > 0
    assert res.params["embed"].device.type == "cpu"


def test_quickstart_main_on_the_cpu(capsys):
    res = quickstart.main(["--device", "cpu", "--days", "1"])
    out = capsys.readouterr().out
    assert "day      auc" in out and len(res.rows) == 1
    assert res.rows[0].steps == 16 and res.rows[0].drops == 0
    assert 0.5 < res.rows[0].auc < 0.6


def test_train_vocab_smoke_on_the_cpu():
    seen = []
    calls = dict(ops.kernel_calls)
    losses = train.run_embedding_smoke(5000, steps=3, embed_dim=16, batch=4,
                                       device="cpu", on_step=seen.append,
                                       log=lambda s: None)
    assert len(losses) == 3 and all(np.isfinite(losses))
    for name in ("pooled_lookup", "pooled_lookup_grad"):
        assert ops.kernel_calls[name] == calls.get(name, 0) + 3
    for i, s in enumerate(seen):
        assert s.ids.shape == (4, 26) and s.ids.dtype == torch.int32
        assert torch.equal(s.pooled, embedding_bag_ref(s.ids, s.table))
        if i:                        # each step looks up the last's update
            assert torch.equal(
                s.table, seen[i - 1].table - 1e-3 * seen[i - 1].table_grad)
        gt, _ = embedding_bag_grad_ref(s.ids, s.pooled_grad, 5000)
        assert torch.equal(s.table_grad, gt)
        # autograd through the plain forward: index_put's accumulate order
        zero = torch.zeros((5000, 16), requires_grad=True)
        (want,) = torch.autograd.grad(embedding_bag_ref(s.ids, zero), zero,
                                      s.pooled_grad)
        torch.testing.assert_close(s.table_grad, want, rtol=1e-6, atol=0)


def test_train_main_cli(capsys):
    assert len(train.main(["--vocab", "1000", "--steps", "2",
                           "--device", "cpu"])) == 2
    assert "step    1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(["--arch", "granite-8b", "--mesh", "4x1", "--ranks", "2",
                    "--device", "cpu"])
    assert "--compress or --ranks needs --fused" in (
        capsys.readouterr().err)


# ---------------------------------------------------------------------------
# parameter handoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adagrad"])
def test_convert_carries_deepfm_and_optimizer_state_bit_for_bit(name):
    jparams = _jax_params()
    jopt = jax_get_optimizer(name, 1e-3)
    batch = {k: jnp.asarray(v) for k, v in _batch(JCFG).items()}
    jstate = jopt.init(jparams)
    jparams, jstate = jopt.update(
        jparams, jax.grad(JR.bce_loss)(jparams, JCFG, batch), jstate)
    tree = _numpy({"params": jparams, "state": jstate})
    port = params_from_jax(tree, device="cpu")
    assert port["params"]["bias"].dim() == 0
    assert isinstance(port["params"]["mlp"], dict)
    back = params_to_numpy(port)
    for k, v in _leaves(tree):
        got = dict(_leaves(back))[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k
    # the carried state continues the JAX optimizer's run
    opt = get_optimizer(name, 1e-3)
    grads = params_from_jax(_numpy(jax.grad(JR.bce_loss)(jparams, JCFG,
                                                         batch)), device="cpu")
    p2, _ = opt.update(port["params"], grads, port["state"])
    jp2, _ = jopt.update(jparams, jax.grad(JR.bce_loss)(jparams, JCFG, batch),
                         jstate)
    _assert_tree_close(p2, jp2, rtol=1e-5, atol=1e-7)


def test_embedding_table_tree_converts_to_the_port_type():
    t = params_from_jax({"table": (np.zeros((3, 2), np.float32),
                                   np.zeros(3, np.int32))}, device="cpu")
    assert isinstance(t["table"], tuple)
    et = params_from_jax({"t": EmbeddingTable(np.zeros((3, 2), np.float32),
                                              np.zeros(3, np.int32))},
                         device="cpu")
    assert isinstance(et["t"], EmbeddingTable)
