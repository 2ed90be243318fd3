"""Paper Tab. 5.2: global QPS of the six training modes, and Tab. 5.3's
fine-grained staleness/drop analysis, from the cluster simulator.

Counterpart of ``benchmarks/bench_tab52_qps.py``'s ``run``, numpy only:
the same rows for the same ``num_batches``.  Scenarios mirror Sec. 5.3's
"different periods of a day": vacant, moderate, strained (Fig. 1's day
cycle).  Claims:

  C3  GBA ~= async QPS; >=2.4x sync under strain; Hop-BS struggles;
  C4  GBA drops orders of magnitude fewer batches than Hop-BW while
      keeping staleness at Hop-BS levels.

The reference's ``run_serving`` (the online-learning serving rows) is not
ported here: its ``audit_race_findings`` column needs the reference's
serving race lint.

    python -m repro_torch.benchmarks.tab52_qps [--num-batches 1920]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks import csv_row
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


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-batches", type=int, default=1920)
    args = ap.parse_args(argv)
    rows = run(args.num_batches)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
