"""The port's static auditor (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the same rule registry, suppressions,
race-lint findings and baseline format on the same inputs; every ported
rule trips on its seeded known-bad torch fixture (exactly that rule) and
the port's own hot paths audit clean; the collective schedule of the
layer-grouped fused step equals the reference's declared one, group by
group."""
from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import race_lint as RRL
from repro.analysis import rules as RR
from repro.analysis.__main__ import load_baseline as ref_load_baseline
from repro_torch.analysis import audit as AU
from repro_torch.analysis import census as CS
from repro_torch.analysis import dataflow as DF
from repro_torch.analysis import race_lint as RL
from repro_torch.analysis import rules as R
from repro_torch.analysis.__main__ import (_parse_minimal_toml,
                                           load_baseline, main,
                                           unused_baseline_entries)
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.distributed import inprocess, process_group
from repro_torch.kernels import runtime
from repro_torch.optim import get_optimizer

ROOT = Path(__file__).resolve().parents[1]
M = 2


def rules_of(findings):
    return sorted({f.rule for f in findings})


def as_tuples(findings):
    return [(f.rule, f.site, f.detail) for f in findings]


def tiny_params(dtype=torch.float32, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return {"emb": torch.randn((32,), generator=gen).to(dtype),
            "layers": {"w": torch.randn((16, 8), generator=gen).to(dtype)}}


def tiny_layout(dtype=torch.float32, m: int = M, group_by=lambda p: p[0]):
    params = tiny_params(dtype)
    return params, ShardedFlatLayout.from_params(params, m, tile=8,
                                                 group_by=group_by)


def fused_record(dtype=torch.float32, m: int = M, compress=None,
                 warm=False, world=inprocess):
    """One probe-loss fused psum step over a RecordingWorld: (layout,
    calls, census mode)."""
    params, layout = tiny_layout(dtype, m)
    batch = {"x": torch.linspace(-1.0, 1.0, m * 4)}
    calls, mode = AU.fused_psum_census(
        layout, m, AU.probe_loss,
        AU.psum_args(layout, params, m, batch, compress),
        compress=compress, warm=warm, world=world)
    return layout, calls, mode


# ---------------------------------------------------------------------------
# rule registry + suppressions
# ---------------------------------------------------------------------------

RESTATED = {"GBA-DON-001",              # for eager PyTorch
            "GBA-TILE-001", "GBA-VMEM-001", "GBA-VMEM-002",
            "GBA-GRID-001"}              # for Hopper's CUDA launches


def test_registry_is_the_references_minus_not_ported():
    assert set(R.RULES) == set(RR.RULES) - set(R.NOT_PORTED)
    assert set(R.NOT_PORTED) == {"GBA-RETRACE-001"}
    for rule, text in R.RULES.items():
        if rule not in RESTATED:
            assert text == RR.RULES[rule], rule
    assert "in place" in R.RULES["GBA-DON-001"]
    assert "TMA" in R.RULES["GBA-TILE-001"]
    assert "shared-memory formula" in R.RULES["GBA-VMEM-001"]
    assert "232,448 B" in R.RULES["GBA-VMEM-002"]
    assert "grid and block" in R.RULES["GBA-GRID-001"]


def test_finding_requires_known_ported_rule():
    with pytest.raises(KeyError):
        R.finding("GBA-NOPE-999", "s", "d")
    with pytest.raises(KeyError):
        R.parse_suppressions(["GBA-NOPE-999"])
    for rule, reason in R.NOT_PORTED.items():
        with pytest.raises(KeyError, match="not ported"):
            R.parse_suppressions([rule])
        with pytest.raises(KeyError, match=reason.split(";")[0][:30]):
            R.finding(rule, "s", "d")


def test_suppressions_match_the_references():
    items = ["GBA-COLL-001@a/k", "GBA-FLOW-002", "GBA-RACE-003@serving/x"]
    assert R.parse_suppressions(items) == RR.parse_suppressions(items)
    specs = [("GBA-COLL-001", "a/k"), ("GBA-COLL-001", "b/k"),
             ("GBA-FLOW-002", "a/k"), ("GBA-RACE-003", "serving/x")]
    port = [R.finding(r, s, "x") for r, s in specs]
    ref = [RR.finding(r, s, "x") for r, s in specs]
    for sup in (items, ["GBA-COLL-001"], []):
        kp, dp = R.apply_suppressions(port, R.parse_suppressions(sup))
        kr, dr = RR.apply_suppressions(ref, RR.parse_suppressions(sup))
        assert (as_tuples(kp), as_tuples(dp)) == (as_tuples(kr),
                                                  as_tuples(dr))
    kept, dropped = R.apply_suppressions(
        port, R.parse_suppressions(["GBA-COLL-001@a/k"]))
    assert kept == port[1:] and dropped == port[:1]


# ---------------------------------------------------------------------------
# collective census (GBA-COLL-*)
# ---------------------------------------------------------------------------

def test_fused_schedule_clean_and_census_shapes():
    layout, calls, _ = fused_record()
    assert CS.check_fused_psum_schedule(calls, layout, M, "t") == []
    gathers = [c.in_shapes[0] for c in calls if c.op == "all_gather"]
    exp, routes = CS.expected_fused_collectives(layout, M)
    assert gathers == exp == [(M, g) for g in layout.group_shard_sizes]
    assert [c.in_shapes[0] for c in calls if c.op == "all_to_all"] == routes
    assert [c.call for c in calls] == (["gather_group"] * 2
                                       + ["route"] * (2 * M)
                                       + ["all_losses"])


def test_schedule_matches_the_references_group_shapes():
    """granite-8b .reduced() at M = 4: one gather a group of the
    reference's exact group-shard shape, in group order, and per worker one
    (M, group_shard) route a group, as the reference declares them."""
    from repro.analysis import audit as RAU
    from repro.analysis import jaxpr_audit as RJA
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    m = AU.AUDIT_M
    ref_layout = RAU.arch_layout(ref_config("granite-8b").reduced(), m)
    ref_gathers, ref_routes, token = RJA.expected_fused_collectives(
        ref_layout, m)
    cfg = get_config("granite-8b").reduced()
    layout = AU.arch_layout(cfg, T.param_shapes(cfg), m)
    gathers, routes = CS.expected_fused_collectives(layout, m)
    assert [(gsn,) for _, gsn in gathers] == ref_gathers
    assert routes == [tuple(r) for r in ref_routes] * m
    assert token == (1,)        # the reference's token gather: no port call
    assert layout.group_keys == ref_layout.group_keys


def test_coll_001_trips_on_mismatched_layout():
    _, calls, _ = fused_record()
    params = tiny_params()
    other = ShardedFlatLayout.from_params(params, M, tile=8)
    fs = CS.check_fused_psum_schedule(calls, other, M, "t")
    assert rules_of(fs) == ["GBA-COLL-001"]


def test_coll_001_trips_on_one_whole_vector_gather():
    """The schedule before the layer-grouped gathers: one gather of the
    whole shard-major vector, then the routes."""
    params, layout = tiny_layout()
    rec = CS.RecordingWorld(inprocess)
    rec.all_gather(layout, layout.ravel(params))
    dst = torch.empty((M, M, layout.shard_size))
    for w in range(M):
        for g in range(layout.num_groups):
            lo, hi = layout.group_shard_bounds(g)
            rec.route(dst, w, lo, hi, torch.zeros((M, hi - lo)))
    rec.all_losses([torch.zeros(())] * M)
    fs = CS.check_fused_psum_schedule(rec.calls, layout, M, "t")
    assert rules_of(fs) == ["GBA-COLL-001"]
    assert any("unexpected collectives ['all_gather']" in f.detail
               for f in fs)


def test_coll_002_trips_on_vector_reduction():
    layout, calls, _ = fused_record()
    bad = calls + [CS.Collective("psum", ((8,),), ("float32",),
                                 "worker_sum")]
    assert rules_of(CS.check_scalar_psum_only(bad, "t")) == ["GBA-COLL-002"]
    assert CS.check_scalar_psum_only(calls, "t") == []


def test_coll_003_trips_on_any_collective():
    _, calls, _ = fused_record()
    assert rules_of(CS.check_no_collectives(calls, "t")) == ["GBA-COLL-003"]
    _, mode = AU.census_run(lambda x: x * 2, torch.ones(4))
    assert CS.check_no_collectives(mode.collectives, "t") == []


def sync_record(m: int = M):
    params = tiny_params()
    opt = get_optimizer("adagrad", 1e-3)
    rec = CS.RecordingWorld(inprocess)
    step = make_gba_psum_step(m, AU.probe_loss, opt, 4, world=rec)
    step(params, opt.init(params), {"x": torch.ones(m * 4)},
         AU.audit_tokens(m), AU.AUDIT_GSTEP)
    return params, rec.calls


def test_coll_004_sync_clean_and_trips_on_wrong_leaves():
    params, calls = sync_record()
    leaf_shapes = [tuple(x.shape) for x in
                   (params["emb"], params["layers"]["w"])]
    assert CS.check_sync_psum_schedule(calls, leaf_shapes, "t") == []
    fs = CS.check_sync_psum_schedule(calls, [(7, 7)], "t")
    assert rules_of(fs) == ["GBA-COLL-004"]
    # the fused step is NOT a valid sync schedule (it gathers + routes)
    _, fused_calls, _ = fused_record()
    assert "GBA-COLL-004" in rules_of(
        CS.check_sync_psum_schedule(fused_calls, leaf_shapes, "t"))


@pytest.mark.parametrize("scheme", ["int8", "onebit"])
def test_coll_005_clean_and_trips_on_f32_leak(scheme):
    pol = CompressionPolicy(scheme=scheme, warmup_steps=1)
    layout, calls, _ = fused_record(compress=pol)
    assert CS.check_wire_dtypes(calls, layout, M, pol, "t") == []
    sides = 2 if scheme == "int8" else 1
    assert [c.in_dtypes[0] for c in calls if c.op == "all_to_all"] == (
        ["int8"] + ["float32"] * sides) * (M * layout.num_groups)
    # known-bad: f32 routing where the policy says the wire is int8
    _, leak, _ = fused_record()
    fs = CS.check_wire_dtypes(leak, layout, M, pol, "t")
    assert rules_of(fs) == ["GBA-COLL-005"]
    # ... but the same f32 wire is exactly what warmup must look like
    assert CS.check_wire_dtypes(leak, layout, M, pol, "t", warm=True) == []
    _, warm, _ = fused_record(compress=pol, warm=True)
    assert CS.check_wire_dtypes(warm, layout, M, pol, "t", warm=True) == []
    assert CS.check_fused_psum_schedule(warm, layout, M, "t") == []


def test_one_rank_gloo_world_records_the_same_schedule(tmp_path):
    """The fused step over a one-rank gloo world holding every shard (the
    card's NCCL world): the same recorded calls as in process, one c10d
    collective each, and the same bits."""
    threads = torch.get_num_threads()
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cpu", timeout=60.0)
    try:
        layout, calls, mode = fused_record(world=world)
        assert CS.check_fused_psum_schedule(calls, layout, M, "t") == []
        assert len(mode.collectives) == len(calls)
        _, in_calls, in_mode = fused_record()
        assert calls == in_calls and in_mode.collectives == []
        params, layout = tiny_layout()
        batch = {"x": torch.linspace(-1.0, 1.0, M * 4)}
        out = []
        for w in (world, inprocess):
            step = make_gba_fused_psum_step(M, AU.probe_loss, layout,
                                            iota=4, lr=1e-3, world=w)
            out.append(step(*AU.psum_args(layout, params, M, batch)))
        for a, b in zip(out[0], out[1]):
            assert torch.equal(a.view(torch.int32) if a.dim() else a,
                               b.view(torch.int32) if b.dim() else b)
    finally:
        process_group.leave()
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# dtype lints (GBA-DTYPE-*) and the in-place lint (GBA-DON-001)
# ---------------------------------------------------------------------------

def test_dtype_001_budget_exact_on_probe_step():
    layout, _, mode = fused_record(torch.bfloat16)
    budget = AU.widening_budget(layout, M)
    assert budget == 2 * M * len(layout.dtypes)     # every leaf is bf16
    assert len(mode.widening) == budget
    assert CS.check_widening_budget(mode.widening, budget, "t") == []
    fs = CS.check_widening_budget(mode.widening, budget - 1, "t")
    assert rules_of(fs) == ["GBA-DTYPE-001"]


def test_dtype_001_ignores_f32_layouts():
    layout, _, mode = fused_record(torch.float32)
    assert AU.widening_budget(layout, M) == 0
    assert CS.check_widening_budget(mode.widening, 0, "t") == []


def test_dtype_002_trips_on_float64_outside_the_plain_versions():
    _, mode = AU.census_run(lambda x: x.double() * 2.0, torch.ones(8))
    assert rules_of(CS.check_no_f64(mode.f64, "t")) == ["GBA-DTYPE-002"]
    _, mode = AU.census_run(lambda x: x * 2.0, torch.ones(8))
    assert CS.check_no_f64(mode.f64, "t") == []

    def plain(x):
        with runtime.plain_region("gba_apply"):
            return (x.double() * 2.0).float()

    _, mode = AU.census_run(plain, torch.ones(8))
    assert mode.f64 == [] and runtime.regions == []


def _toy_fused_train(clone: bool):
    """A flat buffer step at its applying microstep: in place, or (the
    known-bad fixture) with the buffer copied anew."""
    from repro_torch.core.gba import flat_buffer_push_and_maybe_apply
    m, n = 4, 64
    state = {"p": torch.zeros(n), "accum": torch.full((n,), 0.1),
             "buffer": {"grads": torch.zeros((m, n)),
                        "tokens": torch.zeros((m,), dtype=torch.int32),
                        "fill": m - 1, "step": 0}}

    def step(state, g):
        buf = state["buffer"]
        if clone:
            buf = dict(buf, grads=buf["grads"].clone())
        p, a, _, buf = flat_buffer_push_and_maybe_apply(
            buf, g, 0, state["p"], state["accum"], 0.1, iota=4)
        return {"p": p, "accum": a, "buffer": buf}

    from repro_torch.launch.dryrun import LiveBytes
    before = {"buffer": state["buffer"]["grads"], "accum": state["accum"]}
    live = LiveBytes()
    live.held(state)
    with live:
        new = step(state, torch.ones(n))
    return CS.check_in_place(before, {"buffer": new["buffer"]["grads"],
                                      "accum": new["accum"]},
                             live.largest, m * n * 4, "t")


def test_don_001_trips_on_a_second_buffer():
    assert _toy_fused_train(clone=False) == []
    fs = _toy_fused_train(clone=True)
    assert rules_of(fs) == ["GBA-DON-001"] and len(fs) == 2


# ---------------------------------------------------------------------------
# dataflow taint pass (GBA-FLOW-*)
# ---------------------------------------------------------------------------

IOTA = 4
GSTEP = 9
TOKENS = np.array([9, 8, 4, 0], dtype=np.int32)   # slots 2, 3 are stale
STALE = (GSTEP - TOKENS) > IOTA


def _flow_args(p_dtype=torch.float32, step_tensor=False):
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal(8, dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 8), dtype=np.float32))
    step = torch.tensor(GSTEP, dtype=torch.int32) if step_tensor else GSTEP
    return (p.to(p_dtype), g, torch.from_numpy(TOKENS.copy()), step)


SPECS = [DF.taint(DF.PARAM), DF.taint(DF.RAW), DF.taint(DF.TOKEN),
         DF.taint(DF.STEP)]


def _decay_weight(tokens, step):
    return ((step - tokens) <= IOTA).float()


def _run(fn, args, specs=SPECS, **kw):
    _, outs, ctx = DF.analyze(fn, args, specs, site="t", slots=4, **kw)
    return outs, ctx


@pytest.mark.parametrize("step_tensor", [False, True])
def test_flow_001_trips_on_decay_bypass(step_tensor):
    def bad(p, g, tokens, step):
        return p - 0.01 * g.mean(0)                 # no Eq. (1) weighting

    outs, _ = _run(bad, _flow_args(step_tensor=step_tensor))
    fs = DF.check_no_raw(outs, ["p"], lambda _: True, "t")
    assert rules_of(fs) == ["GBA-FLOW-001"]

    def good(p, g, tokens, step):
        w = _decay_weight(tokens, step)
        return p - 0.01 * (g * w[:, None]).sum(0)

    outs, ctx = _run(good, _flow_args(step_tensor=step_tensor))
    assert DF.check_no_raw(outs, ["p"], lambda _: True, "t") == []
    # the recorded mask proves the tombstone weights too
    assert DF.check_tombstone(ctx, STALE, "t") == []


def test_flow_002_trips_on_soft_tombstone_weight():
    def soft(p, g, tokens, step):
        # decays stale slots to 0.01 instead of dropping them: close
        # enough to fool a numeric diff, rejected by the exact-zero rule
        w = torch.where((step - tokens) <= IOTA, 0.25, 0.01)
        return p - (g * w[:, None]).sum(0)

    _, ctx = _run(soft, _flow_args())
    fs = DF.check_tombstone(ctx, STALE, "t")
    assert rules_of(fs) == ["GBA-FLOW-002"]
    assert "EXACTLY" in fs[0].detail
    # a mask not traceable to a per-slot weight vector is unprovable
    _, _, ctx = DF.analyze(soft, _flow_args(), SPECS, site="t", slots=3)
    assert rules_of(DF.check_tombstone(ctx, STALE, "t")) == ["GBA-FLOW-002"]


def test_flow_003_trips_when_residual_reaches_apply():
    def bad(p, g, r, tokens, step):
        w = _decay_weight(tokens, step)
        upd = ((g + r) * w[:, None]).sum(0)         # residual in update
        return p - 0.01 * upd, r

    def good(p, g, r, tokens, step):
        w = _decay_weight(tokens, step)
        upd = (g * w[:, None]).sum(0)
        return p - 0.01 * upd, r + upd    # residual -> next quantize only

    p, g, tokens, step = _flow_args()
    args = (p, g, torch.zeros((4, 8)), tokens, step)
    specs = [DF.taint(DF.PARAM), DF.taint(DF.RAW), DF.taint(DF.RESIDUAL),
             DF.taint(DF.TOKEN), DF.taint(DF.STEP)]
    outs, _ = _run(bad, args, specs)
    fs = DF.check_no_residual(outs[:1], ["p"], lambda _: True, "t")
    assert rules_of(fs) == ["GBA-FLOW-003"]
    assert DF.check_no_raw(outs[:1], ["p"], lambda _: True, "t") == []
    outs, _ = _run(good, args, specs)
    assert DF.check_no_residual(outs[:1], ["p"], lambda _: True, "t") == []


def test_flow_003_quantize_is_the_sanctioned_residual_producer():
    """The quantize wrapper's plain version: its codes and sidebands drop
    'residual', the payload (the next residual, in place) keeps it."""
    from repro_torch.kernels import ops

    def q(x):
        return ops.quantize_wire(x, tile=8, mode="minmax")

    x = torch.linspace(-1.0, 1.0, 32).reshape(2, 16)
    mode = DF.FlowMode(DF.FlowContext("t"))
    mode.seed(x, frozenset({DF.RESIDUAL}))
    with runtime.observe(mode), mode:
        codes, scale, zero = q(x)
    assert [DF.RESIDUAL in mode.tags(t) for t in (x, codes, scale, zero)] \
        == [True, False, False, False]


def test_flow_004_trips_on_narrow_update_chain():
    bf = torch.bfloat16

    def bad_arith(p, g, tokens, step):
        w = _decay_weight(tokens, step)
        upd = (g * w[:, None]).sum(0)
        return p - (0.01 * upd).to(bf)            # bf16 subtract

    def bad_nonterminal(p, g, tokens, step):
        w = _decay_weight(tokens, step)
        upd = (g * w[:, None]).sum(0)
        return (p.float() - 0.01 * upd).to(bf) * 2

    def good(p, g, tokens, step):
        w = _decay_weight(tokens, step)
        upd = (g * w[:, None]).sum(0)
        return (p.float() - 0.01 * upd).to(bf)

    for fn in (bad_arith, bad_nonterminal):
        _, ctx = _run(fn, _flow_args(bf), f32_chain=True)
        assert rules_of(ctx.findings) == ["GBA-FLOW-004"], fn.__name__
    _, ctx = _run(good, _flow_args(bf), f32_chain=True)
    assert ctx.findings == []


def test_flow_005_trips_on_constant_divisor():
    def bad(ids, g, tokens, step):
        w = _decay_weight(tokens, step)
        return (g * w[:, None]).sum(0) / 4.0      # mean over M, not
        #                                           over contributors

    def missing(ids, g, tokens, step):
        w = _decay_weight(tokens, step)
        return (g * w[:, None]).sum(0)            # no mean at all

    def good(ids, g, tokens, step):
        valid = (ids >= 0).float()
        w = _decay_weight(tokens, step) * valid
        num = (g * w[:, None]).sum(0)
        return num / torch.clamp(w.sum(), min=1.0)

    _, g, tokens, step = _flow_args()
    args = (torch.tensor([0, -1, 3, 2], dtype=torch.int32), g, tokens, step)
    specs = [DF.taint(DF.IDS), DF.taint(DF.RAW), DF.taint(DF.TOKEN),
             DF.taint(DF.STEP)]
    for fn in (bad, missing):
        _, ctx = _run(fn, args, specs)
        assert rules_of(DF.check_divisor(ctx, "t")) == ["GBA-FLOW-005"], \
            fn.__name__
    _, ctx = _run(good, args, specs)
    assert DF.check_divisor(ctx, "t") == []


def test_flow_seed_arity_mismatch_raises():
    with pytest.raises(ValueError):
        DF.analyze(lambda p, g, t, s: p, _flow_args(), SPECS[:2], site="t")


# ---------------------------------------------------------------------------
# serving-thread race lint (GBA-RACE-*)
# ---------------------------------------------------------------------------

RACE_BAD1 = '''
import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def locked_add(self, n):
        with self._lock:
            self.total += n

    def unlocked_add(self, n):
        self.total += n
'''

RACE_BAD2 = '''
import threading


class Versioned:
    def __init__(self):
        self._lock = threading.Lock()
        self.version = 0
        self.step = 0

    def bump(self):
        with self._lock:
            self.version = self.version + 1
            self.step = self.step + 2

    def view(self):
        return (self.version, self.step)
'''

RACE_BAD3 = '''
import threading


class Publisher:
    def __init__(self):
        self._lock = threading.Lock()
        self._listeners = []
        self.value = 0

    def subscribe(self, fn):
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, v):
        for fn in list(self._listeners):
            fn(v)

    def publish(self, v):
        with self._lock:
            self.value = v
            self._notify(v)
'''

RACE_GOOD_SNAPSHOT = '''
import threading


class Source:
    def __init__(self):
        self._lock = threading.Lock()
        self._snap = (0, 0)

    def update(self, v, s):
        self._snap = (v, s)     # plain rebind of an immutable snapshot

    def view(self):
        snap = self._snap       # ONE unlocked read: consistent by design
        return snap
'''

# the reference's _on_sync order (src/repro/serving/recsys.py:110-117):
# the hot-ID cache is bumped after the lock is released
ON_SYNC_CACHE_AFTER_LOCK = '''
import threading


class RecsysScoringEngine:
    def __init__(self, source, cache=None):
        self._sync_lock = threading.Lock()
        self._table = None
        self._mlp = None
        self._version = 0
        self.param_step = 0
        self.syncs_adopted = 0
        self.cache = cache
        source.add_listener(self._on_sync)

    def _on_sync(self, snap, touched):
        table = snap.params["table"]
        with self._sync_lock:
            self._table = table
            self._mlp = snap.params["mlp"]
            self._version = snap.version
            self.param_step = snap.step
            self.syncs_adopted += 1
        if self.cache is not None:
            self.cache.bump_version(snap.version, touched)

    def _pin(self):
        with self._sync_lock:
            return self._table, self._mlp, self._version
'''

FIXTURES = {"bad1": RACE_BAD1, "bad2": RACE_BAD2, "bad3": RACE_BAD3,
            "good": RACE_GOOD_SNAPSHOT}


def _lint_both(sources):
    fp, sp = RL.lint_sources(sources)
    fr, sr = RRL.lint_sources(sources)
    assert as_tuples(fp) == as_tuples(fr) and sp == sr
    return fp, sp


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_race_fixtures_match_the_references(name):
    fs, stats = _lint_both({name: FIXTURES[name]})
    want = {"bad1": (["GBA-RACE-001"], "unlocked_add"),
            "bad2": (["GBA-RACE-002"], "view"),
            "bad3": (["GBA-RACE-003"], "publish"),
            "good": ([], None)}[name]
    assert rules_of(fs) == want[0]
    if want[1]:
        assert want[1] in fs[0].site
    else:
        assert stats["race_classes"] == 1


def test_race_lint_matches_the_reference_on_its_serving_modules():
    root = ROOT / "src" / "repro"
    sources = {Path(rel).stem: (root / rel).read_text()
               for rel in RRL.DEFAULT_MODULES}
    _lint_both(sources)
    assert RL.DEFAULT_MODULES == RRL.DEFAULT_MODULES


def test_race_lint_on_the_references_on_sync_order():
    """The lint reports nothing on the reference's order (the cache bumped
    after the lock): the cache's version is another object's state, which
    the lint does not follow.  The port bumps it under the lock
    (``serving/recsys.py``); the serving tests hold that, not the lint."""
    fs, stats = _lint_both({"recsys": ON_SYNC_CACHE_AFTER_LOCK})
    assert fs == [] and stats["race_entries"] == 1
    assert stats["race_guarded_attrs"] == 5


def test_shipped_serving_race_free():
    rep = AU.audit_serving()
    assert rep.ok, [str(f) for f in rep.findings]
    assert rep.stats["race_entries"] >= 1
    assert rep.stats["race_guarded_attrs"] >= 1
    assert rep.stats["race_locked_regions"] >= 1


# ---------------------------------------------------------------------------
# the layout's group unravel against the reference
# ---------------------------------------------------------------------------

def test_unravel_group_matches_the_reference():
    import jax.numpy as jnp
    from repro.core.flat_sharded import ShardedFlatLayout as RefLayout

    rng = np.random.default_rng(3)
    shapes = {"a": (5, 3), "b": {"c": (17,), "d": (2, 2, 3)}, "e": (9,)}
    np_params = {"a": rng.standard_normal((5, 3), dtype=np.float32),
                 "b": {"c": rng.standard_normal(17, dtype=np.float32),
                       "d": rng.standard_normal((2, 2, 3),
                                                dtype=np.float32)},
                 "e": rng.standard_normal(9, dtype=np.float32)}
    group = lambda path: "b" if path[0] == "b" else "rest"
    ref_group = lambda names: group(names)
    jp = {"a": jnp.asarray(np_params["a"], jnp.bfloat16),
          "b": {k: jnp.asarray(v) for k, v in np_params["b"].items()},
          "e": jnp.asarray(np_params["e"])}
    tp = {"a": torch.from_numpy(np_params["a"]).to(torch.bfloat16),
          "b": {k: torch.from_numpy(v) for k, v in np_params["b"].items()},
          "e": torch.from_numpy(np_params["e"])}
    ref = RefLayout.from_params(jp, 3, tile=4, group_by=ref_group)
    port = ShardedFlatLayout.from_params(tp, 3, tile=4, group_by=group)
    assert port.group_shard_sizes == ref.group_shard_sizes
    flat = np.asarray(ref.ravel(jp))
    assert np.array_equal(port.ravel(tp).numpy(), flat)
    rows = flat.reshape(3, -1)
    for g in range(ref.num_groups):
        lo, hi = ref.group_shard_bounds(g)
        gflat = rows[:, lo:hi].reshape(-1)
        for dtype, jdt in ((None, None), (torch.float32, jnp.float32)):
            want = ref.unravel_group(g, jnp.asarray(gflat), jdt)
            for view in (torch.from_numpy(gflat.copy()),
                         torch.from_numpy(flat.copy()).view(3, -1)[:, lo:hi]):
                got = port.unravel_group(g, view, dtype)
                for a, b in zip(got, want):
                    assert np.array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
                    assert str(a.dtype).split(".")[-1] == str(b.dtype)
    tree = port.unravel(torch.from_numpy(flat.copy()))
    want = ref.unravel(jnp.asarray(flat))
    assert np.array_equal(tree["b"]["d"].numpy(), np.asarray(want["b"]["d"]))
    assert np.array_equal(tree["a"].float().numpy(),
                          np.asarray(want["a"], np.float32))
    del shapes


# ---------------------------------------------------------------------------
# audit baseline file (--baseline .gba-audit-torch.toml)
# ---------------------------------------------------------------------------

BASELINE = "\n".join([
    "# comment",
    "[[suppress]]",
    'rule = "GBA-COLL-001"',
    'site = "a/k"   # trailing comment',
    'reason = "deliberate"',
    "[[suppress]]",
    'rule = "GBA-FLOW-002"',
    'reason = "fleet-wide"',
])


def test_baseline_parse_roundtrip_matches_the_references(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text(BASELINE)
    assert load_baseline(p) == ref_load_baseline(p) == [
        ("GBA-COLL-001", "a/k", "deliberate"),
        ("GBA-FLOW-002", None, "fleet-wide")]
    assert _parse_minimal_toml(BASELINE)["suppress"][0]["rule"] == \
        "GBA-COLL-001"
    with pytest.raises(ValueError):
        _parse_minimal_toml("rule = unquoted")


def test_baseline_requires_rule_reason_and_file(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('[[suppress]]\nrule = "GBA-COLL-001"\n')
    with pytest.raises(SystemExit):
        load_baseline(p)                       # reason is mandatory
    p.write_text('[[suppress]]\nreason = "no rule"\n')
    with pytest.raises(SystemExit):
        load_baseline(p)                       # rule is mandatory
    with pytest.raises(SystemExit):
        load_baseline(tmp_path / "missing.toml")


def test_baseline_naming_a_not_ported_rule_is_refused(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('[[suppress]]\nrule = "GBA-RETRACE-001"\nreason = "x"\n')
    with pytest.raises(SystemExit, match="not ported"):
        main(["--arch", "granite-8b", "--baseline", str(p)])


def test_baseline_unused_entries_and_checked_in_file():
    rep = types.SimpleNamespace(
        suppressed=[R.finding("GBA-COLL-001", "a/k", "x")])
    entries = [("GBA-COLL-001", "a/k", "r"), ("GBA-COLL-001", "b/k", "r"),
               ("GBA-FLOW-002", None, "r")]
    assert unused_baseline_entries(entries, [rep]) == entries[1:]
    assert load_baseline(ROOT / ".gba-audit-torch.toml") == []


# ---------------------------------------------------------------------------
# the port's hot paths audit clean
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    return AU.audit_arch("granite-8b")


def test_granite_full_matrix_clean(granite):
    rep = granite
    assert rep.ok, [str(f) for f in rep.findings]
    g, m = rep.stats["num_groups"], AU.AUDIT_M
    # per group: one gather; per group and worker: one route; one psum
    assert rep.stats["all_gather"] == g == 4
    assert rep.stats["all_to_all"] == m * g
    assert rep.stats["psum"] == 1
    assert rep.stats["compressed_all_to_all"] == 3 * m * g
    assert rep.stats["widening_converts"] == 2 * m * 9


def test_run_audit_reports_as_the_reference():
    reports = AU.run_audit(["granite-8b"])
    assert [r.name for r in reports] == ["granite-8b", "kernels", "dataflow",
                                         "serving"]
    assert all(r.ok for r in reports), [str(f) for r in reports
                                        for f in r.findings]
    assert reports[0].stats["apply_smem_bytes"] == 4 * AU.AUDIT_M


def test_shipped_dataflow_audit_clean():
    rep = AU.audit_dataflow()
    assert rep.ok, [str(f) for f in rep.findings]


def test_cli_check_granite(tmp_path, capsys):
    assert main(["--check", "--arch", "granite-8b"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "granite-8b" in out
    assert "] kernels" in out and "flash_decode_ring[" in out
    p = tmp_path / "b.toml"
    p.write_text('[[suppress]]\nrule = "GBA-COLL-001"\n'
                 'site = "granite-8b/none"\nreason = "stale"\n')
    assert main(["--check", "--arch", "granite-8b", "--markdown",
                 "--baseline", str(p)]) == 0
    cap = capsys.readouterr()
    assert "unused baseline suppression GBA-COLL-001@granite-8b/none" \
        in cap.err
    assert "| granite-8b | ✅ clean | 4/16/1 |" in cap.out
    assert "| kernels | ✅ clean | — |" in cap.out
