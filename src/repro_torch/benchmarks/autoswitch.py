"""Beyond-paper: adaptive switching controller evaluation.

Counterpart of ``benchmarks/bench_autoswitch.py``, numpy only: the same
rows for the same ``num_batches``.  A 12-phase trace alternates between
vacant and strained cluster phases; each phase is split into 4 telemetry
sub-windows and the controller decides per sub-window from the previous
sub-window's per-worker rates (PS-side observable).  Policies:
always-sync, always-gba, adaptive, oracle.

The finite PS service rate (``ps_throughput``) reproduces Fig. 1's
crossover: sync wins on a vacant cluster, GBA under strain, so neither
static policy is optimal and the adaptive controller must beat both.

    python -m repro_torch.benchmarks.autoswitch
"""
from __future__ import annotations

import time
from dataclasses import replace

from repro_torch.benchmarks import csv_row
from repro_torch.core.autoswitch import AutoSwitchController
from repro_torch.sim.cluster import ClusterSpec, simulate

VACANT = ClusterSpec(num_workers=16, straggler_frac=0.0, jitter=0.05,
                     ps_throughput=100.0)
STRAINED = ClusterSpec(num_workers=16, straggler_frac=0.25,
                       straggler_slowdown=10.0, jitter=0.2,
                       time_varying=True, ps_throughput=100.0)
# a day in the shared cluster (Fig. 1)
PHASES = [VACANT] * 3 + [STRAINED] * 4 + [VACANT] * 2 + [STRAINED] * 2 \
    + [VACANT]
SUBWINDOWS = 4


def _window(spec: ClusterSpec, mode: str, num_batches: int, seed: int):
    sched = simulate(replace(spec, seed=seed), mode, num_batches, 256,
                     buffer_size=16, iota=4)
    return sched.metrics.wall_time, sched.metrics.worker_rates


def run(num_batches: int = 480) -> list[str]:
    t0 = time.perf_counter()
    rows = []
    nb = max(32, num_batches // SUBWINDOWS)
    totals = {"sync": 0.0, "gba": 0.0, "oracle": 0.0, "adaptive": 0.0}
    ctrl = AutoSwitchController()
    modes_log = []
    prev_rates = None
    for i, spec in enumerate(PHASES):
        for j in range(SUBWINDOWS):
            seed = 100 + i * SUBWINDOWS + j
            t_sync, r_sync = _window(spec, "sync", nb, seed)
            t_gba, r_gba = _window(spec, "gba", nb, seed)
            totals["sync"] += t_sync
            totals["gba"] += t_gba
            totals["oracle"] += min(t_sync, t_gba)
            mode = ctrl.mode if prev_rates is None else ctrl.decide(
                prev_rates)
            t_ad, prev_rates = (t_sync, r_sync) if mode == "sync" \
                else (t_gba, r_gba)
            totals["adaptive"] += t_ad
        modes_log.append(mode)
    for k, v in totals.items():
        rows.append(csv_row(f"autoswitch.total_time.{k}", 0.0,
                            f"seconds={v:.1f}"))
    regret = (totals["adaptive"] - totals["oracle"]) / totals["oracle"]
    beats_static = totals["adaptive"] < min(totals["sync"], totals["gba"])
    us = (time.perf_counter() - t0) * 1e6
    rows.append(csv_row(
        "autoswitch.claims", us,
        f"phase_end_modes="
        f"{''.join('S' if m == 'sync' else 'G' for m in modes_log)};"
        f"regret_vs_oracle={regret:.1%};beats_both_static={beats_static}"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
