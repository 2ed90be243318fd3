"""The port's switching harness (``repro_torch.launch.switch_driver``)
against the JAX package's (``repro.launch.switch_driver``), on the CPU.

* The carryover (``pad_mask``, ``tree_to_flat``, ``flat_to_tree``) on the
  non-tile-multiple tree of ``tests/test_switch_driver.py``, bit for bit;
  ``SwitchConfig`` and the constructor refuse what the reference refuses;
  the demo model's weights are the reference's draw.
* The replays and the chaos cases of ``tests/test_switch_driver.py``'s
  slow scripts: the reference runs them in a subprocess on a forced
  4-device CPU mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
  and hands its results over in an npz file; the port runs them here with
  the reference's initial weights.  Every simulated-clock field is equal.
  The fused replays of the 8-step schedule (one Eq. (1)-decayed slot and
  one tombstone at step 5) run on the wire tests' loss (``x`` in
  multiples of 1/8, sums of squares folded in halves), whose gradients
  are bit-exact in both frameworks: params, accumulator and losses are
  then bit-identical to the reference's, switched or not.  The demo MLP's
  matmuls and ``tanh`` round differently in XLA and PyTorch, so its runs
  are held within 1e-5, and its swaps bit-exact within the port.  The
  reference's own psum run of ``sync x3, gba x3, sync x2`` fails on JAX
  0.9 at its gba -> sync swap (``flat_to_tree`` raises a
  ``ShardingTypeError``), so the port's is held to the reference's fused
  run of the same schedule.
* The traps of an in-place port: runs share no state, the swap check
  compares storage of its own, a non-finite loss commits nothing, one
  representation is live at a time.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.switch_driver as JSD
from repro.core.flat_sharded import ShardedFlatLayout as JaxLayout
from repro.sim.cluster import ClusterSpec as JaxClusterSpec
from repro.sim.faults import FaultPlan as JaxFaultPlan
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.staleness import threshold_decay
from repro_torch.launch import switch_driver as SD
from repro_torch.sim.cluster import ClusterSpec
from repro_torch.sim.faults import FaultPlan, ScrapeDropout, StragglerWindow

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
M, IOTA, LB = 4, 4, 8
# the simulated-clock and fault fields of a SwitchResult: equal to the
# reference's for the same spec, plan, seed and sizes
SIM_FIELDS = ("wall_time", "samples", "num_global_steps", "switch_count",
              "time_to_first_switch_steps", "mode_timeline", "mode_steps",
              "mode_time", "crashes", "rejoins", "timeouts", "lost_batches",
              "dropped_batches", "tombstones", "drained", "stalled_barriers",
              "apply_failures", "breaker_trips", "dropped_scrapes",
              "swaps_verified", "warm_steps", "controller_summary", "qps")
MODES = {"switched": ["sync"] * 3 + ["gba"] * 3 + ["sync"] * 2,
         "gba": ["gba"] * 8, "sync": ["sync"] * 8,
         "late": ["sync"] * 3 + ["gba"] * 5}


def _schedule():
    """The reference's 8-step schedule: step 5 holds an Eq. (1)-decayed
    slot (token 0) and a tombstone slot (batch -1)."""
    steps, b = [], 0
    for k in range(8):
        toks, bats = [k] * 4, []
        for _ in range(4):
            bats.append(b)
            b += 1
        if k == 5:
            toks[1] = 0
            toks[2] = k - IOTA - 1
            bats[2] = -1
        steps.append((tuple(toks), tuple(bats)))
    return steps


def sim_fields(res) -> str:
    """The simulated fields as one comparable string (NaN included)."""
    out = res if isinstance(res, dict) else res.to_json()
    return json.dumps({k: out[k] for k in SIM_FIELDS}, sort_keys=True)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the reference's runs, in a subprocess
# ---------------------------------------------------------------------------

_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.compression import CompressionPolicy
from repro.launch.switch_driver import (GlobalStep, SwitchConfig,
                                        SwitchDriver, demo_batch_fn,
                                        demo_model)
from repro.sim.cluster import ClusterSpec
from repro.sim.faults import FaultPlan, ScrapeDropout, StragglerWindow

inp = dict(np.load(sys.argv[1]))
steps = [GlobalStep(tuple(t), tuple(b)) for t, b in json.loads(sys.argv[3])]
modes = json.loads(sys.argv[4])
mesh = jax.make_mesh((4,), ("data",))
out, fields = {}, {}

def fold(v):
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = jnp.concatenate([v, jnp.zeros((n - v.shape[0],), v.dtype)])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]

def fold_loss(p, batch):
    s = None
    for leaf in jax.tree.leaves(p):
        f = leaf.astype(jnp.float32).reshape(-1)
        s = fold(f * f) if s is None else s + fold(f * f)
    return jnp.mean(batch["x"]) * s

fold_params = {"embed": jnp.asarray(inp["embed"]),
               "head": jnp.asarray(inp["head"]),
               "blocks": {"l0": {"w": jnp.asarray(inp["w"]),
                                 "b": jnp.asarray(inp["b"])}}}
demo_params, demo_loss, group_by = demo_model()
for path, leaf in jax.tree_util.tree_flatten_with_path(demo_params)[0]:
    out["init/" + "/".join(k.key for k in path)] = np.asarray(leaf)
models = {
    "fold": (fold_params, fold_loss, lambda i: {"x": inp["x"][i]}),
    "demo": (demo_params, demo_loss, demo_batch_fn(8)),
}

def keep(name, r):
    out[name + "/param"] = r.param_flat
    out[name + "/accum"] = r.accum_flat
    out[name + "/losses"] = np.float32(r.losses)
    fields[name] = r.to_json()

for model, (params, loss_fn, batch_fn) in models.items():
    for impl, runs in (("fused", ("switched", "gba", "sync")),
                       ("psum", ("late", "sync"))):
        drv = SwitchDriver(mesh, loss_fn, params, spec=ClusterSpec(4),
                           plan=FaultPlan.quiet(4),
                           cfg=SwitchConfig(local_batch=8, iota=4,
                                            sync_impl=impl),
                           batch_fn=batch_fn, group_by=group_by)
        for run in runs:
            keep(f"{model}/{impl}/{run}", drv.run_schedule(steps, modes[run]))

# the chaos cases of tests/test_switch_driver.py
spec = ClusterSpec(num_workers=4, jitter=0.05, seed=0)
def chaos(plan, cfg=None, **kw):
    return SwitchDriver(mesh, demo_loss, demo_params, spec=spec, plan=plan,
                        cfg=cfg or SwitchConfig(local_batch=8,
                                                sync_impl="fused"),
                        batch_fn=demo_batch_fn(8), group_by=group_by, **kw)
keep("breaker", chaos(FaultPlan(4, apply_failures=(0, 1, 2)),
                      SwitchConfig(local_batch=8, sync_impl="fused",
                                   breaker_threshold=3)).run(
    48, mode="gba", seed=0))
keep("dropout", chaos(FaultPlan(4, stragglers=(StragglerWindow(0, 4.0),),
                                dropouts=(ScrapeDropout(0.0, float("inf")),))
                      ).run(48, mode="auto", seed=0))
keep("reentry", chaos(FaultPlan.quiet(4), compress=CompressionPolicy(
    scheme="int8", warmup_steps=2)).run(
    48, mode_schedule=lambda g: "sync" if g < 2 or 6 <= g < 8 else "gba",
    seed=0))
np.savez(sys.argv[2], **out)
print(json.dumps(fields))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("switch")
    rng = np.random.default_rng(7)
    inp = {"embed": rng.standard_normal((33, 9)),
           "w": rng.standard_normal((41,)), "b": rng.standard_normal((7, 5)),
           "head": rng.standard_normal((700,)),
           "x": rng.integers(1, 17, (32, LB, 4)) * rng.choice(
               [-1.0, 1.0], (32, LB, 4)) / 8}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(tmp / "in.npz", **inp)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(_schedule()), json.dumps(MODES)],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fields = json.loads(proc.stdout.strip().splitlines()[-1])
    return inp, dict(np.load(tmp / "out.npz")), fields


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _fold(v: torch.Tensor) -> torch.Tensor:
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = torch.cat([v, v.new_zeros(n - v.shape[0])])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def _fold_loss(p, batch):
    s = None
    for _, leaf in tree_paths(p):
        f = leaf.float().reshape(-1)
        s = _fold(f * f) if s is None else s + _fold(f * f)
    return batch["x"].mean() * s


def _model(name, inp, ref):
    """(params, loss_fn, batch_fn, group_by) of the port, from the
    reference's inputs."""
    if name == "fold":
        params = {"embed": torch.from_numpy(inp["embed"]),
                  "head": torch.from_numpy(inp["head"]),
                  "blocks": {"l0": {"w": torch.from_numpy(inp["w"]),
                                    "b": torch.from_numpy(inp["b"])}}}
        return (params, _fold_loss, lambda i: {"x": inp["x"][i]},
                lambda path: path[0])
    _, loss_fn, group_by = SD.demo_model(device="cpu")
    params = {}
    for k, v in ref.items():
        if k.startswith("init/"):
            _, mod, leaf = k.split("/")
            params.setdefault(mod, {})[leaf] = torch.from_numpy(v)
    return params, loss_fn, SD.demo_batch_fn(LB), group_by


def _driver(params, loss_fn, batch_fn, group_by, *, impl="fused",
            plan=None, spec=None, **kw):
    cfg = kw.pop("cfg", None) or SD.SwitchConfig(local_batch=LB, iota=IOTA,
                                                 sync_impl=impl)
    return SD.SwitchDriver(M, loss_fn, params, spec=spec or ClusterSpec(M),
                           plan=plan or FaultPlan.quiet(M), cfg=cfg,
                           batch_fn=batch_fn, group_by=group_by, **kw)


def _steps():
    return [SD.GlobalStep(t, b) for t, b in _schedule()]


@pytest.fixture(scope="module")
def port(reference):
    inp, ref, _ = reference
    runs = {}
    for model in ("fold", "demo"):
        parts = _model(model, inp, ref)
        for impl, names in (("fused", ("switched", "gba", "sync")),
                            ("psum", ("switched", "late", "sync"))):
            drv = _driver(*parts, impl=impl)
            for name in names:
                runs[f"{model}/{impl}/{name}"] = drv.run_schedule(
                    _steps(), MODES[name])
    params, loss_fn, batch_fn, group_by = _model("demo", inp, ref)
    spec = ClusterSpec(num_workers=M, jitter=0.05, seed=0)
    fused = SD.SwitchConfig(local_batch=LB, sync_impl="fused")

    def chaos(plan, cfg=fused, **kw):
        return _driver(params, loss_fn, batch_fn, group_by, plan=plan,
                       spec=spec, cfg=cfg, **kw)
    runs["breaker"] = chaos(
        FaultPlan(M, apply_failures=(0, 1, 2)),
        SD.SwitchConfig(local_batch=LB, sync_impl="fused",
                        breaker_threshold=3)).run(48, mode="gba", seed=0)
    runs["dropout"] = chaos(FaultPlan(
        M, stragglers=(StragglerWindow(0, 4.0),),
        dropouts=(ScrapeDropout(0.0, float("inf")),))).run(
        48, mode="auto", seed=0)
    runs["reentry"] = chaos(FaultPlan.quiet(M), compress=CompressionPolicy(
        scheme="int8", warmup_steps=2)).run(
        48, mode_schedule=lambda g: "sync" if g < 2 or 6 <= g < 8 else "gba",
        seed=0)
    return runs


@pytest.mark.parametrize("run", ["switched", "gba", "sync"])
def test_fused_replays_are_bit_identical_to_the_reference(reference, port,
                                                          run):
    _, ref, fields = reference
    got, name = port[f"fold/fused/{run}"], f"fold/fused/{run}"
    assert sim_fields(got) == sim_fields(fields[name])
    for what, mine in (("param", got.param_flat), ("accum", got.accum_flat),
                       ("losses", got.losses)):
        assert np.array_equal(_bits(mine), _bits(ref[f"{name}/{what}"])), \
            what
    assert got.switch_count == (2 if run == "switched" else 0)
    assert got.dropped_batches == 1 and got.tombstones == 1


@pytest.mark.parametrize("model", ["fold", "demo"])
def test_fused_swaps_are_bit_exact_against_unswitched_runs(port, model):
    sw = port[f"{model}/fused/switched"]
    for other in ("gba", "sync"):
        un = port[f"{model}/fused/{other}"]
        assert np.array_equal(_bits(sw.param_flat), _bits(un.param_flat))
        assert np.array_equal(_bits(sw.accum_flat), _bits(un.accum_flat))
        assert np.array_equal(_bits(sw.losses), _bits(un.losses))


@pytest.mark.parametrize("name", ["fold/psum/late", "fold/psum/sync",
                                  "demo/psum/late", "demo/psum/sync",
                                  "demo/fused/switched"])
def test_replays_match_the_reference_within_1e_5(reference, port, name):
    _, ref, fields = reference
    got = port[name]
    assert sim_fields(got) == sim_fields(fields[name])
    for what, mine in (("param", got.param_flat), ("accum", got.accum_flat),
                       ("losses", np.float32(got.losses))):
        np.testing.assert_allclose(mine, ref[f"{name}/{what}"], rtol=0,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("model", ["fold", "demo"])
def test_psum_switched_replay_matches_the_reference_fused_run(reference,
                                                              port, model):
    _, ref, _ = reference
    got = port[f"{model}/psum/switched"]
    assert got.swaps_verified == 2 and got.switch_count == 2
    for what, mine in (("param", got.param_flat),
                       ("accum", got.accum_flat)):
        np.testing.assert_allclose(
            mine, ref[f"{model}/fused/switched/{what}"], rtol=0, atol=1e-5,
            err_msg=what)


@pytest.mark.parametrize("case", ["breaker", "dropout", "reentry"])
def test_chaos_cases_match_the_reference(reference, port, case):
    _, ref, fields = reference
    got = port[case]
    assert sim_fields(got) == sim_fields(fields[case])
    np.testing.assert_allclose(got.losses, ref[f"{case}/losses"], rtol=1e-5)
    want = {"breaker": dict(breaker_trips=1, apply_failures=3,
                            mode_steps={"sync": 9}, drained=4),
            "dropout": dict(switch_count=0),
            "reentry": dict(switch_count=3, warm_steps=4)}[case]
    for k, v in want.items():
        assert getattr(got, k) == v, k


# ---------------------------------------------------------------------------
# carryover, configuration, constructor
# ---------------------------------------------------------------------------

def _jax_tree():
    """``tests/test_switch_driver.py``'s tree of non-tile-multiple
    leaves."""
    k = jax.random.PRNGKey(0)
    return {"emb": jax.random.normal(k, (37, 33)),
            "mlp": {"w": jax.random.normal(jax.random.PRNGKey(1), (33,)),
                    "b": jax.random.normal(jax.random.PRNGKey(2), (7, 5))},
            "head": jax.random.normal(jax.random.PRNGKey(3), (111,))}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def test_carryover_matches_the_reference_bit_for_bit():
    jp = _jax_tree()
    jacc = jax.tree.map(
        lambda l: jax.random.uniform(jax.random.PRNGKey(9), l.shape) + 0.1,
        jp)
    jlay = JaxLayout.from_params(jp, 4, tile=256, group_by=lambda n: n[0])
    lay = ShardedFlatLayout.from_params(_to_torch(jp), 4, tile=256,
                                        group_by=lambda n: n[0])
    assert np.array_equal(_bits(SD.pad_mask(lay)),
                          _bits(JSD.pad_mask(jlay)))
    jpf, jaf = JSD.tree_to_flat(jlay, jp, jacc, initial_accum=0.1)
    pf, af = SD.tree_to_flat(lay, _to_torch(jp), _to_torch(jacc),
                             initial_accum=0.1)
    assert np.array_equal(_bits(pf), _bits(jpf))
    assert np.array_equal(_bits(af), _bits(jaf))
    jp2, jo2 = JSD.flat_to_tree(jlay, jpf, jaf)
    p2, o2 = SD.flat_to_tree(lay, pf, af)
    for (_, a), (_, b) in zip(tree_paths(p2), tree_paths(_to_torch(jp2))):
        assert np.array_equal(_bits(a), _bits(b))
    for (_, a), (_, b) in zip(tree_paths(o2["accum"]),
                              tree_paths(_to_torch(jo2["accum"]))):
        assert np.array_equal(_bits(a), _bits(b))
    # flat -> tree -> flat closes
    pf2, af2 = SD.tree_to_flat(lay, p2, o2["accum"], initial_accum=0.1)
    assert torch.equal(pf2, pf) and torch.equal(af2, af)


def test_accumulator_stays_float32_for_bfloat16_params():
    p = {"w": torch.ones((300,), dtype=torch.bfloat16)}
    lay = ShardedFlatLayout.from_params(p, 2, tile=128)
    accum = {"w": torch.full((300,), 0.1234567)}
    pf, af = SD.tree_to_flat(lay, p, accum, initial_accum=0.1)
    params, opt = SD.flat_to_tree(lay, pf, af)
    assert params["w"].dtype == torch.bfloat16
    assert opt["accum"]["w"].dtype == torch.float32
    assert torch.equal(opt["accum"]["w"], accum["w"])
    assert lay.unravel(af)["w"].dtype == torch.bfloat16    # the default


@pytest.mark.parametrize("bad", [dict(sync_impl="allreduce"),
                                 dict(local_batch=0), dict(decide_every=0),
                                 dict(breaker_threshold=0),
                                 dict(max_retries=-1)])
def test_switch_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JSD.SwitchConfig(**bad)
    with pytest.raises(ValueError):
        SD.SwitchConfig(**bad)
    assert SD.SwitchConfig().push_timeout is None


def test_demo_model_is_the_reference_draw():
    """The demo weights are ``jax.random.normal`` reproduced in numpy:
    within 4 ulps, and almost all of them bit for bit (XLA's ``log1p``
    may round the last bit otherwise)."""
    jparams, _, _ = JSD.demo_model()
    params, _, _ = SD.demo_model(device="cpu")
    equal = total = 0
    for (path, a), (_, b) in zip(tree_paths(params),
                                 tree_paths(_to_torch(jparams)),
                                 strict=True):
        d = np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))
        assert d.max() <= 4, path
        equal, total = equal + int((d == 0).sum()), total + d.size
    assert equal / total > 0.95


def test_driver_refuses_what_the_reference_refuses():
    params, loss_fn, group_by = SD.demo_model(device="cpu")
    with pytest.raises(ValueError, match="workers"):
        SD.SwitchDriver(1, loss_fn, params, spec=ClusterSpec(num_workers=2),
                        plan=FaultPlan.quiet(2),
                        cfg=SD.SwitchConfig(local_batch=8),
                        batch_fn=SD.demo_batch_fn(8), group_by=group_by)
    with pytest.raises(ValueError, match="leading dim"):
        SD.SwitchDriver(1, loss_fn, params, spec=ClusterSpec(num_workers=1),
                        plan=FaultPlan.quiet(1),
                        cfg=SD.SwitchConfig(local_batch=16),
                        batch_fn=SD.demo_batch_fn(8), group_by=group_by)


def _one_worker(impl="fused", batch_fn=None, jax_side=False):
    cfg_kw = dict(local_batch=8, sync_impl=impl)
    if jax_side:
        params, loss_fn, group_by = JSD.demo_model()
        return JSD.SwitchDriver(
            jax.make_mesh((1,), ("data",)), loss_fn, params,
            spec=JaxClusterSpec(num_workers=1, jitter=0.0, seed=0),
            plan=JaxFaultPlan.quiet(1), cfg=JSD.SwitchConfig(**cfg_kw),
            batch_fn=batch_fn or JSD.demo_batch_fn(8), group_by=group_by,
            tile=128)
    params, loss_fn, group_by = SD.demo_model(device="cpu")
    return SD.SwitchDriver(
        1, loss_fn, params,
        spec=ClusterSpec(num_workers=1, jitter=0.0, seed=0),
        plan=FaultPlan.quiet(1), cfg=SD.SwitchConfig(**cfg_kw),
        batch_fn=batch_fn or SD.demo_batch_fn(8), group_by=group_by,
        tile=128)


def _nan_at(k):
    """The demo batches, batch ``k`` all NaN."""
    plain = SD.demo_batch_fn(8)

    def batch_fn(i):
        b = plain(i)
        return {n: np.full_like(v, np.nan) for n, v in b.items()} \
            if i == k else b
    return batch_fn


@pytest.mark.parametrize("impl", ["fused", "psum"])
@pytest.mark.parametrize("nan", [False, True])
def test_one_worker_run_matches_the_reference(impl, nan):
    """The reference's 1-worker smoke (a quiet cluster never leaves
    sync), and the same run with one NaN batch: a failed apply that
    commits nothing and is counted once."""
    batch_fn = _nan_at(3) if nan else None
    got = _one_worker(impl, batch_fn).run(6, mode="auto", seed=0)
    want = _one_worker(impl, batch_fn, jax_side=True).run(6, mode="auto",
                                                          seed=0)
    assert sim_fields(got) == sim_fields(want)
    assert got.apply_failures == int(nan)
    assert got.num_global_steps == 6 - int(nan)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(got.param_flat, want.param_flat, atol=1e-5)
    np.testing.assert_allclose(got.accum_flat, want.accum_flat, rtol=1e-5)


def test_run_rejects_unknown_mode_and_bad_schedule():
    drv = _one_worker()
    with pytest.raises(ValueError):
        drv.run(2, mode="warp")
    with pytest.raises(ValueError):
        drv.run_schedule([SD.GlobalStep((0,), (0,))], ["sync", "gba"])
    with pytest.raises(ValueError):
        drv.run_schedule([SD.GlobalStep((0, 0), (0, 1))], ["sync"])


# ---------------------------------------------------------------------------
# the traps of a port whose steps write in place
# ---------------------------------------------------------------------------

def _demo_driver(impl, **kw):
    params, loss_fn, group_by = SD.demo_model(device="cpu")
    return _driver(params, loss_fn, SD.demo_batch_fn(LB), group_by,
                   impl=impl, **kw)


@pytest.mark.parametrize("impl", ["fused", "psum"])
def test_two_runs_of_one_driver_are_identical(impl):
    """Every run starts from the initial params, not from where the last
    run's in-place steps left them."""
    drv = _demo_driver(impl, plan=SD.demo_plan("strained", M),
                       spec=SD.demo_spec(M))
    p0 = [x.clone() for _, x in tree_paths(drv._params0)]
    a, b = drv.run(24, mode="auto"), drv.run(24, mode="auto")
    assert a.switch_count >= 1
    assert sim_fields(a) == sim_fields(b)
    assert np.array_equal(_bits(a.param_flat), _bits(b.param_flat))
    assert np.array_equal(_bits(a.accum_flat), _bits(b.accum_flat))
    assert a.losses == b.losses
    for x, (_, y) in zip(p0, tree_paths(drv._params0)):
        assert torch.equal(x, y)
    # the result is a copy: a later run does not move it
    before = a.param_flat.copy()
    drv.run(8, mode="gba")
    assert np.array_equal(a.param_flat, before)


@pytest.mark.parametrize("corrupt", ["value", "alias"])
def test_swap_check_catches_a_bad_conversion(monkeypatch, corrupt):
    """A conversion that changes a bit, or a check that would compare a
    tensor with itself, makes the swap raise."""
    drv = _demo_driver("psum")
    real = SD.flat_to_tree

    def bad(layout, pf, af):
        params, opt = real(layout, pf, af)
        if corrupt == "value":
            params["l1"]["w"].view(-1)[7] += 1.0
            return params, opt
        return st.params, st.opt               # the live tree itself

    st = drv._fresh_state("sync")
    monkeypatch.setattr(SD, "flat_to_tree", bad)
    with pytest.raises(RuntimeError, match="itself" if corrupt == "alias"
                       else "not bit-exact"):
        drv._swap(st, "gba")


@pytest.mark.parametrize("mode,impl", [("sync", "fused"), ("sync", "psum"),
                                       ("gba", "fused")])
def test_a_nan_batch_commits_nothing(mode, impl):
    drv = _demo_driver(impl)
    st = drv._fresh_state(mode)
    before = drv._canonical_flat(st)
    nan = {k: np.full_like(v, np.nan) for k, v in drv.batch_fn(0).items()}
    loss = drv._exec(st, np.zeros(M, np.int64), [nan] * M)
    assert math.isnan(loss)
    after = drv._canonical_flat(st)
    for x, y in zip(before, after):
        assert np.array_equal(_bits(x), _bits(y))


def test_a_nan_compressed_step_restarts_the_wire():
    drv = _demo_driver("fused", compress=CompressionPolicy(
        scheme="int8", warmup_steps=1))
    st = drv._fresh_state("gba")
    ok = drv._exec(st, np.zeros(M, np.int64),
                   [drv.batch_fn(i) for i in range(M)])
    assert math.isfinite(ok) and st.warm_count == 1
    before = drv._canonical_flat(st)
    nan = {k: np.full_like(v, np.nan) for k, v in drv.batch_fn(0).items()}
    assert math.isnan(drv._exec(st, np.zeros(M, np.int64), [nan] * M))
    for x, y in zip(before, drv._canonical_flat(st)):
        assert np.array_equal(_bits(x), _bits(y))
    assert st.warm_count == 0 and not st.wire["residual"].any()


def test_tombstone_tokens_weigh_exactly_zero():
    for gstep in (0, 5, 100):
        tok = torch.tensor([gstep, gstep - IOTA, gstep - IOTA - 1],
                           dtype=torch.int32)
        w = threshold_decay(tok, gstep, IOTA)
        assert w.tolist() == [1.0, 1.0, 0.0]
        assert not torch.signbit(w[2])


def test_one_representation_is_live_at_a_time():
    drv = _demo_driver("psum", compress=CompressionPolicy(
        scheme="int8", warmup_steps=2))
    st = drv._fresh_state("sync")
    assert st.pf is None and st.af is None
    drv._swap(st, "gba")
    assert st.params is None and st.opt is None
    assert st.pf is not None and st.wire is not None
    drv._swap(st, "sync")
    assert st.pf is None and st.af is None and st.wire is None
    assert st.params is not None and st.result.swaps_verified == 2
