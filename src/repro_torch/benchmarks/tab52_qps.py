"""Paper Tab. 5.2: global QPS of the six training modes, and Tab. 5.3's
fine-grained staleness/drop analysis, from the cluster simulator.

Counterpart of ``benchmarks/bench_tab52_qps.py``: ``run`` is numpy only
and gives the same rows for the same ``num_batches``.  Scenarios mirror
Sec. 5.3's "different periods of a day": vacant, moderate, strained
(Fig. 1's day cycle).  Claims:

  C3  GBA ~= async QPS; >=2.4x sync under strain; Hop-BS struggles;
  C4  GBA drops orders of magnitude fewer batches than Hop-BW while
      keeping staleness at Hop-BS levels.

``run_serving`` benches the online-learning serving side of the same
workload (GBA Sec. 5: the trained model is continuously redeployed) at the
paper's scale, V = 1M, as ``bench_tab52_qps.run_serving`` does: Zipf-hot
scoring through the :class:`~repro_torch.embeddings.hot_cache.HotIDCache`
in front of the ``embedding_bag`` kernel, and live param sync through
``UpdateChannel``/``LiveSource`` with touched-row invalidation.  Its
structural columns are the reference's: ``audit_hit_skips_kernel`` is the
wrapper census's proof that an all-hit batch never reaches the lookup
kernel, and ``audit_race_findings`` is the lock-discipline lint
(``repro_torch.analysis.race_lint``) over the serving modules it drives.
Everything is seeded and the sync thread is off (pull-based
``sync_now``), so every column but the latencies is deterministic and
equal to the reference's; the latencies are host wall time.

    python -m repro_torch.benchmarks.tab52_qps [--num-batches 1920]
        [--device cuda|cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.analysis.race_lint import lint_default
from repro_torch.benchmarks import csv_row
from repro_torch.embeddings.table import hash_ids
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving import (LiveSource, RecsysScoringEngine,
                                 ServingConfig, StaticSource, UpdateChannel,
                                 init_scoring_params)
from repro_torch.sim.cluster import ClusterSpec, simulate

SCENARIOS = {
    "vacant": ClusterSpec(num_workers=16, straggler_frac=0.0, jitter=0.02,
                          seed=7),
    "moderate": ClusterSpec(num_workers=16, straggler_frac=0.12,
                            straggler_slowdown=3.0, jitter=0.1,
                            time_varying=True, seed=7),
    "strained": ClusterSpec(num_workers=16, straggler_frac=0.25,
                            straggler_slowdown=5.0, jitter=0.2,
                            time_varying=True, seed=7),
}

MODES = [("sync", {}), ("async", {}), ("hop_bs", dict(b1=2)),
         ("bsp", dict(b2=16)), ("hop_bw", dict(b3=4)),
         ("gba", dict(buffer_size=16, iota=4))]


def run(num_batches: int = 1920) -> list[str]:
    rows = []
    t0 = time.perf_counter()
    summary = {}
    for sc_name, spec in SCENARIOS.items():
        for mode, kw in MODES:
            reps = []
            for rep in range(3):
                m = simulate(
                    ClusterSpec(**{**spec.__dict__, "seed": spec.seed + rep}),
                    mode, num_batches, 256, **kw).metrics
                reps.append(m)
            qps = np.array([m.qps for m in reps])
            rows.append(csv_row(
                f"tab52.qps.{sc_name}.{mode}", 0.0,
                f"qps={qps.mean():.0f};std={qps.std():.0f};"
                f"avg_stale={np.mean([m.avg_staleness for m in reps]):.2f};"
                f"max_stale={max(m.staleness_max for m in reps)};"
                f"drops={int(np.mean([m.dropped_batches for m in reps]))}"))
            summary[(sc_name, mode)] = (
                qps.mean(),
                np.mean([m.avg_staleness for m in reps]),
                np.mean([m.dropped_batches for m in reps]))
    us = (time.perf_counter() - t0) * 1e6 / (len(SCENARIOS) * len(MODES) * 3)

    g, a = summary[("strained", "gba")], summary[("strained", "async")]
    s, bw = summary[("strained", "sync")], summary[("strained", "hop_bw")]
    hb = summary[("strained", "hop_bs")]
    rows.append(csv_row(
        "tab52.claims", us,
        f"gba_vs_async_qps={g[0] / a[0]:.3f};"
        f"gba_vs_sync_speedup={g[0] / s[0]:.2f}x;"
        f"claim_2.4x={'PASS' if g[0] / s[0] >= 2.4 else 'FAIL'};"
        f"hopbw_drops={bw[2]:.0f};gba_drops={g[2]:.0f};"
        f"gba_stale={g[1]:.2f};hopbs_stale={hb[1]:.2f}"))
    return rows


# -- online-learning serving (tab52.serving.*) ----------------------------

SERVE_V = 1_000_000       # embedding rows: the paper-scale vocab
SERVE_DIM = 64
SERVE_HOT = 512           # Zipf-hot head the cache should absorb
SERVE_CACHE = 4096        # cache capacity (rows)
SERVE_B, SERVE_F = 8, 16  # request geometry: (B, F) ID lists
SERVE_SYNC_EVERY = 8      # scored batches per applied sync
SERVE_PUBS_PER_SYNC = 2   # trainer publishes coalesced into each sync
SERVE_TOUCH = 16          # embedding rows each trainer update touches


def _hot_batch(rng: np.random.Generator, hot: np.ndarray) -> np.ndarray:
    """(B, F) raw ids, Zipf-skewed inside the hot pool."""
    ranks = rng.zipf(1.2, size=(SERVE_B, SERVE_F)) - 1
    return hot[np.minimum(ranks, hot.shape[0] - 1)]


def run_serving(num_batches: int = 64, *,
                device: str | torch.device = "cuda") -> list[str]:
    """The ``tab52.serving.hot_cache`` and ``tab52.serving.live_sync``
    rows, scoring on ``device`` from weights drawn from seed 0."""
    dev = resolve_device(device)
    rows = []
    params = init_scoring_params(SERVE_V, SERVE_DIM,
                                 generator=torch.Generator().manual_seed(0),
                                 device=dev)
    cfg = ServingConfig(cache_capacity=SERVE_CACHE)
    hot = np.arange(SERVE_HOT, dtype=np.int64)
    race_findings, _ = lint_default()

    # ---- hot-ID cache in front of the lookup kernel (frozen params) ------
    eng = RecsysScoringEngine(StaticSource(params), config=cfg, device=dev)
    rng = np.random.default_rng(0)
    eng.score(hot.reshape(1, -1))          # warm: one pool over the hot set
    eng.latencies_us.clear()
    for _ in range(num_batches):
        eng.score(_hot_batch(rng, hot))
    # a batch whose ids are all resident makes no lookup-kernel call
    probe = _hot_batch(rng, hot)
    eng.score(probe)                       # make the probe's ids resident
    before = ops.kernel_calls["pooled_lookup"]
    eng.score(probe)
    hit_skips = int(ops.kernel_calls["pooled_lookup"] == before)
    st = eng.stats()
    rows.append(csv_row(
        "tab52.serving.hot_cache", st["p50_us"],
        f"p50_us={st['p50_us']:.0f};p99_us={st['p99_us']:.0f};"
        f"hit_rate={st['hit_rate']:.4f};vocab={SERVE_V};"
        f"cache_rows={st['cache_rows']};"
        f"audit_cache_bytes={st['cache_bytes']};"
        f"audit_hit_skips_kernel={hit_skips};"
        f"audit_race_findings={len(race_findings)}"))

    # ---- live param sync: freshness + touched-row invalidation -----------
    chan = UpdateChannel()
    live = LiveSource(chan, params, sync_interval=cfg.sync_interval,
                      start=False)         # pull-based: deterministic
    eng = RecsysScoringEngine(live, config=cfg, device=dev)
    rng = np.random.default_rng(1)
    eng.score(hot.reshape(1, -1))
    eng.latencies_us.clear()
    table = params["table"]
    bump = torch.full((SERVE_TOUCH, SERVE_DIM), 0.01, device=dev)
    step = max_lag = syncs = 0
    for i in range(num_batches):
        eng.score(_hot_batch(rng, hot))
        if (i + 1) % SERVE_SYNC_EVERY == 0:
            for _ in range(SERVE_PUBS_PER_SYNC):
                step += 1
                touch = hash_ids(torch.from_numpy(
                    rng.choice(SERVE_HOT, SERVE_TOUCH)), SERVE_V)
                # out of place: the published snapshots hold the old
                # tables; index_add adds a repeated row once a repeat
                table = table._replace(table=table.table.index_add(
                    0, touch.to(dev, torch.long), bump))
                chan.publish({"table": table, "mlp": params["mlp"]}, step,
                             touched_ids=touch.numpy())
            max_lag = max(max_lag, live.freshness_lag_steps())
            live.sync_now()
            syncs += 1
    st = eng.stats()
    rows.append(csv_row(
        "tab52.serving.live_sync", st["p50_us"],
        f"p50_us={st['p50_us']:.0f};p99_us={st['p99_us']:.0f};"
        f"hit_rate={st['hit_rate']:.4f};"
        f"freshness_lag_steps={max_lag};syncs={syncs};"
        f"coalesced={chan.coalesced};"
        f"invalidations={eng.cache.invalidations};"
        f"versions={st['param_version']};"
        f"audit_race_findings={len(race_findings)}"))
    eng.close()
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-batches", type=int, default=1920,
                    help="simulated batches of each QPS run")
    ap.add_argument("--device", default="cuda",
                    help="where the serving rows score: cuda or cpu")
    args = ap.parse_args(argv)
    rows = run(args.num_batches) + run_serving(device=args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
