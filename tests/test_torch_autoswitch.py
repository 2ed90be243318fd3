"""The port's autoswitch controller, its benches and its switching CLI
against the JAX package's, on the CPU.

* Each case of ``tests/test_autoswitch.py`` runs on both packages'
  ``AutoSwitchController`` with the same rates, and a hypothesis test
  drives ``decide`` over random rate sequences: estimates, decisions,
  histories and summaries are equal.
* ``repro_torch.benchmarks.autoswitch.run`` gives the reference bench's
  rows at a small size.
* ``python -m repro_torch.launch.switch_driver --workers 4 --batches 240
  --plan {strained,quiet} --compare-sync --json`` against the reference's
  CLI on a forced 4-device CPU mesh (both plans run at once, in
  subprocesses): every simulated-clock field equal, the final loss within
  1e-5 relative (the demo model's weights are the reference's draw, its
  float32 sums in other orders); ``fig6_switching.run_switching`` gives the
  rows the reference builds from its JSON.
* The Fig. 6 continual protocol at 1 base and 1 eval day against the
  reference bench (``slow``: about 45 s on the JAX side), AUC within 1e-3.
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
from hypothesis import given, settings, strategies as st

import repro.core.autoswitch as jax_autoswitch
import repro.sim.cluster as jax_cluster
import repro_torch.core.autoswitch as torch_autoswitch
import repro_torch.sim.cluster as torch_cluster
from repro_torch.benchmarks import autoswitch as bench_autoswitch
from repro_torch.benchmarks import fig6_switching

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"reference": (jax_autoswitch.AutoSwitchController, jax_cluster),
            "port": (torch_autoswitch.AutoSwitchController, torch_cluster)}
STRAGGLER = [100.0] * 15 + [10.0]


def _trace(c, calls):
    """Run ``calls`` (method name, argument) on controller ``c``; record
    each return, the dead-worker count, the history and the summary, with
    NaN made comparable."""
    out = []
    for name, arg in calls:
        try:
            got = getattr(c, name)(*([] if arg is None else [arg]))
        except ValueError:
            got = "ValueError"
        out.append((name, got, c.dead_workers, c.mode))
    out.append(("history", list(c.history)))
    out.append(("summary", c.summary()))
    return json.dumps(out, default=float)


CASES = {
    "homogeneous": ({}, [("estimate_speedup", np.full(16, 100.0))]),
    "straggler": ({}, [("estimate_speedup", np.array(STRAGGLER))]),
    "empty_window": ({}, [("estimate_speedup", []), ("decide", []),
                          ("decide", np.array(STRAGGLER)), ("decide", []),
                          ("decide", np.array([]))]),
    "summary_empty": ({}, [("summary", None), ("decide", [])]),
    "bytes_on_wire": (
        {"wire_bytes_per_step": {"sync": 4.0 * (1 << 20),
                                 "gba": 0.251 * 4.0 * (1 << 20)}},
        [("summary", None), ("decide", np.array(STRAGGLER))]),
    "bounded_history": ({"max_history": 16},
                        [("decide", np.full(4, 100.0 + i))
                         for i in range(100)]),
    "hysteresis": ({"switch_up": 1.5, "switch_down": 1.15},
                   [("decide", np.array([100.0] * 15 + [20.0])),
                    ("decide", np.array([100.0] * 15 + [80.0])),
                    ("decide", np.full(16, 100.0))]),
    "dead_worker": ({}, [("estimate_speedup", [1.0, 1.0, 1.0, 0.0]),
                         ("decide", [1.0, 1.0, 1.0, 0.0]),
                         ("estimate_speedup", [100.0, 100.0, 10.0, 0.0])]),
    "all_dead": ({}, [("estimate_speedup", [0.0, 0.0]),
                      ("decide", [0.0, 0.0])]),
    "min_dwell": ({"min_dwell": 2},
                  [("decide", [10.0, 1.0, 1.0, 1.0])]
                  + [("decide", [1.0, 1.0, 1.0, 1.0])] * 3),
    "no_dwell": ({}, [("decide", [10.0, 1.0, 1.0, 1.0]),
                      ("decide", [1.0, 1.0, 1.0, 1.0])]),
    "force": ({"min_dwell": 2, "mode": "gba"},
              [("force", "sync")] + [("decide", [10.0, 1.0, 1.0, 1.0])] * 3
              + [("force", "warp"), ("force", "gba")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_matches_the_reference(case):
    kw, calls = CASES[case]
    traces = {k: _trace(ctrl(**kw), calls)
              for k, (ctrl, _) in PACKAGES.items()}
    assert traces["port"] == traces["reference"]


@pytest.mark.parametrize("kind", ["tracks_cluster", "ps_crossover"])
def test_controller_on_the_simulator_matches_the_reference(kind):
    """``test_controller_tracks_cluster_state`` and
    ``test_ps_throughput_cap_crossover``, each package on its own
    simulator: rates, decisions and throughputs equal."""
    out = {}
    for k, (ctrl, cl) in PACKAGES.items():
        if kind == "tracks_cluster":
            vac = cl.ClusterSpec(num_workers=8, straggler_frac=0.0,
                                 jitter=0.05, ps_throughput=100.0, seed=1)
            strained = cl.ClusterSpec(num_workers=8, straggler_frac=0.5,
                                      straggler_slowdown=10.0, jitter=0.1,
                                      ps_throughput=100.0, seed=1)
            c = ctrl()
            rates = [cl.simulate(vac, "sync", 64, 128).metrics.worker_rates,
                     cl.simulate(strained, "sync", 64,
                                 128).metrics.worker_rates,
                     cl.simulate(vac, "gba", 64, 128, buffer_size=8,
                                 iota=4).metrics.worker_rates]
            out[k] = ([np.asarray(r).tolist() for r in rates],
                      [c.decide(r) for r in rates])
        else:
            q = {}
            for name, spec in (
                    ("vac", cl.ClusterSpec(num_workers=16,
                                           straggler_frac=0.0, jitter=0.05,
                                           ps_throughput=100.0, seed=3)),
                    ("str", cl.ClusterSpec(num_workers=16,
                                           straggler_frac=0.25,
                                           straggler_slowdown=10.0,
                                           jitter=0.2, time_varying=True,
                                           ps_throughput=100.0, seed=3))):
                for mode in ("sync", "gba"):
                    q[f"{name}/{mode}"] = cl.simulate(
                        spec, mode, 480, 256, buffer_size=16,
                        iota=4).metrics.qps
            out[k] = q
    assert out["port"] == out["reference"]
    if kind == "tracks_cluster":
        assert out["port"][1] == ["sync", "gba", "sync"]
    else:
        q = out["port"]
        assert q["vac/sync"] > q["vac/gba"]
        assert q["str/gba"] > 2.0 * q["str/sync"]


_RATE = st.one_of(st.just(0.0), st.floats(1e-3, 1e6, allow_nan=False))


@settings(deadline=None, max_examples=60, database=None)
@given(windows=st.lists(st.lists(_RATE, min_size=0, max_size=8),
                        min_size=1, max_size=12),
       dwell=st.integers(0, 3), up=st.floats(1.0, 3.0),
       down=st.floats(1.0, 1.5), forced=st.integers(-1, 11))
def test_decide_matches_the_reference_on_random_rates(windows, dwell, up,
                                                      down, forced):
    calls = [("decide", w) for w in windows]
    if 0 <= forced < len(calls):
        calls.insert(forced, ("force", "sync"))
    kw = dict(min_dwell=dwell, switch_up=up, switch_down=down)
    traces = {k: _trace(ctrl(**kw), calls)
              for k, (ctrl, _) in PACKAGES.items()}
    assert traces["port"] == traces["reference"]


def _strip_us(row: str) -> tuple:
    """A CSV row without its host-clock column."""
    name, _, derived = row.split(",", 2)
    return name, derived


def test_autoswitch_bench_matches_the_reference():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import bench_autoswitch as reference
    finally:
        sys.path.remove(str(ROOT))
    want = [_strip_us(r) for r in reference.run(num_batches=128)]
    got = [_strip_us(r) for r in bench_autoswitch.run(num_batches=128)]
    assert got == want
    assert got[-1][0] == "autoswitch.claims"


# ---------------------------------------------------------------------------
# the switching CLI, both plans, against the reference's
# ---------------------------------------------------------------------------

PLANS = ("strained", "quiet")
SIM_FIELDS = ("wall_time", "samples", "num_global_steps", "switch_count",
              "time_to_first_switch_steps", "mode_timeline", "mode_steps",
              "mode_time", "crashes", "rejoins", "timeouts", "lost_batches",
              "dropped_batches", "tombstones", "drained", "stalled_barriers",
              "apply_failures", "breaker_trips", "dropped_scrapes",
              "swaps_verified", "warm_steps", "controller_summary", "qps",
              "plan", "deadlocked", "sync_wall_time", "sync_qps",
              "sync_timeouts", "sync_rejoins", "speedup_vs_sync")


def _cli(module: str, plan: str, *extra: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", module, "--workers", "4", "--batches", "240",
         "--plan", plan, "--mode", "auto", "--compare-sync", "--json",
         *extra], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def cli_runs():
    """The reference's CLI for both plans, started together, beside the
    port's ``run_switching``."""
    procs = {p: _cli("repro.launch.switch_driver", p, "--host-devices", "4")
             for p in PLANS}
    port = fig6_switching.switching_results(device="cpu")
    ref = {}
    for p, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        ref[p] = json.loads(out.strip().splitlines()[-1])
    return ref, port


@pytest.mark.parametrize("plan", PLANS)
def test_cli_matches_the_reference(cli_runs, plan):
    ref, port = cli_runs
    got, want = port[plan][0], ref[plan]
    assert json.dumps({k: got[k] for k in SIM_FIELDS}) == \
        json.dumps({k: want[k] for k in SIM_FIELDS})
    assert math.isclose(got["final_loss"], want["final_loss"], rel_tol=1e-5)
    if plan == "strained":
        assert got["speedup_vs_sync"] == 2.5005865516398864 >= 2.0
        assert (got["num_global_steps"], got["switch_count"],
                got["time_to_first_switch_steps"], got["mode_steps"],
                got["crashes"], got["rejoins"], got["lost_batches"],
                got["sync_timeouts"], got["sync_rejoins"]) == (
            60, 1, 4, {"sync": 4, "gba": 56}, 1, 1, 1, 1, 1)


def test_run_switching_rows_match_the_reference(cli_runs):
    ref, port = cli_runs
    got = fig6_switching.switching_rows(port)
    want = fig6_switching.switching_rows({p: (ref[p], 0.0) for p in PLANS})
    assert [_strip_us(r) for r in got] == [_strip_us(r) for r in want]


def test_switch_driver_cli_needs_a_card_by_default():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.switch_driver",
         "--batches", "8"], env={**os.environ,
                                 "PYTHONPATH": str(ROOT / "src")},
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()


# ---------------------------------------------------------------------------
# the Fig. 6 continual protocol
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fig6_run_matches_the_reference():
    from repro.configs.recsys import CRITEO_DEEPFM as JCFG
    from repro.models.recsys import init_recsys as jax_init_recsys
    from repro_torch.convert import params_from_jax
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import bench_fig6_switching as reference
    finally:
        sys.path.remove(str(ROOT))
    jparams = jax_init_recsys(jax.random.PRNGKey(0), JCFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    want = reference.run(base_days=1, eval_days=1)
    got = fig6_switching.run(base_days=1, eval_days=1, device="cpu",
                             params=params)
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    for g, w in zip(got, want):
        gd = dict(kv.split("=") for kv in g.split(",", 2)[2].split(";"))
        wd = dict(kv.split("=") for kv in w.split(",", 2)[2].split(";"))
        assert gd.keys() == wd.keys()
        for k in gd:
            if k == "gba_beats_baselines":
                continue
            # AUCs within 1e-3, differences of two AUCs within 2e-3, each
            # printed to 4 decimals
            tol = (2e-3 if k in ("drop_vs_sync", "gba_first_day_gap")
                   else 1e-3) + 1e-4
            for a, b in zip(gd[k].split("|"), wd[k].split("|")):
                assert abs(float(a) - float(b)) <= tol, (k, g, w)
