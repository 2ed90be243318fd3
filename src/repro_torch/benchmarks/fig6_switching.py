"""Paper Fig. 6 / Tables 6.1-6.8: continual training with mode switching.

Counterpart of ``benchmarks/bench_fig6_switching.py``.  Protocol (scaled):
pretrain a base model in sync mode for ``base_days``, then (a) switch to
each compared mode for ``eval_days`` (Fig. 6 a-c), and (b) train each mode
then switch back to sync (Fig. 6 d-f).  AUC on the next day after each
training day.  Claims:

  C2a  GBA's first-day AUC after switching ~= sync (no sudden drop);
  C2b  GBA >= the semi-sync baselines on average;
  C2c  pure async with the sync hyper-parameter set collapses.

:func:`run_switching` is the switching harness's trajectory: it spawns
``python -m repro_torch.launch.switch_driver`` once a plan (the auto and
forced-sync legs on the same plan) and reports the rows of the
reference's ``run_switching``: strained ``speedup_vs_sync``,
``switch_count`` and ``time_to_switch_steps``.  The simulated clock does
not depend on the steps' wall time, so those columns are exact for a
seed.

    python -m repro_torch.benchmarks.fig6_switching [--switching] \\
        [--base-days 8] [--eval-days 3] [--device cuda]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.benchmarks import csv_row
from repro_torch.configs.recsys import CRITEO_DEEPFM
from repro_torch.core import default_setups, run_continual
from repro_torch.data import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.recsys import init_recsys
from repro_torch.sim.cluster import ClusterSpec

CFG = CRITEO_DEEPFM
MODES = ["gba", "hop_bs", "bsp", "hop_bw", "async", "async_setS"]

# the reference's fixed trajectory size
SWITCH_WORKERS = 4
SWITCH_BATCHES = 240
SRC = Path(__file__).resolve().parents[2]


def _driver_json(plan: str, device: str) -> dict:
    """One ``switch_driver`` subprocess run (auto and forced-sync legs on
    the same plan); its last stdout line is the JSON result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.switch_driver",
         "--workers", str(SWITCH_WORKERS),
         "--batches", str(SWITCH_BATCHES), "--plan", plan,
         "--mode", "auto", "--compare-sync", "--json", "--device", device],
        capture_output=True, text=True, timeout=900, env=env)
    if proc.returncode != 0:
        raise RuntimeError(
            f"switch_driver --plan {plan} failed:\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def switching_rows(results: dict[str, tuple[dict, float]]) -> list[str]:
    """The rows of :func:`run_switching` from each plan's driver JSON and
    its microseconds."""
    rows = []
    for plan, (out, us) in results.items():
        derived = (f"switch_count={out['switch_count']};"
                   f"deadlocked={out['deadlocked']};"
                   f"crashes={out['crashes']};rejoins={out['rejoins']};"
                   f"sync_timeouts={out['sync_timeouts']};"
                   f"lost_tokens={out['lost_batches']};"
                   f"swaps_verified={out['swaps_verified']};"
                   f"speedup_vs_sync={out['speedup_vs_sync']:.4f}")
        if out["time_to_first_switch_steps"] is not None:
            derived += (f";time_to_switch_steps="
                        f"{out['time_to_first_switch_steps']}")
        rows.append(csv_row(f"fig6.switch_driver.{plan}", us, derived))
    return rows


def switching_results(device: str = "cuda") -> dict[str, tuple[dict,
                                                             float]]:
    """Each plan's driver JSON and its microseconds, one subprocess a
    plan."""
    results = {}
    for plan in ("strained", "quiet"):
        t0 = time.perf_counter()
        out = _driver_json(plan, device)
        results[plan] = (out, (time.perf_counter() - t0) * 1e6)
    return results


def run_switching(device: str = "cuda") -> list[str]:
    """The switching trajectory's rows."""
    return switching_rows(switching_results(device))


def run(base_days: int = 8, eval_days: int = 3, *,
        device: str | torch.device = "cuda", params: Any = None
        ) -> list[str]:
    """The continual protocol's rows.  The base model is drawn from seed 0
    (on the CPU, as ``init_recsys`` draws) and runs on ``device``, unless
    ``params`` (on ``device``) are given."""
    dev = resolve_device(device)
    stream = make_clickstream(CFG, seed=0, batches_per_day=48,
                              batch_size=256,
                              num_days=base_days + 2 * eval_days + 2)
    setups = default_setups(base_global=2048)
    spec = ClusterSpec(num_workers=16, straggler_frac=0.25,
                       straggler_slowdown=5.0, jitter=0.2, seed=0)
    t0 = time.perf_counter()

    base = params if params is not None else init_recsys(
        CFG, generator=torch.Generator().manual_seed(0), device=dev)
    base, res0 = run_continual(base, CFG, stream, ["sync"] * base_days,
                               setups, spec, eval_batches=16)
    sync_auc = res0.auc_per_day[-1]
    rows = [csv_row("fig6.base_sync", 0.0,
                    f"auc_last={sync_auc:.4f};"
                    f"curve={'|'.join(f'{a:.4f}' for a in res0.auc_per_day)}")]

    # continued sync = the reference line
    _, res_sync = run_continual(base, CFG, stream, ["sync"] * eval_days,
                                setups, spec, eval_batches=16,
                                start_day=base_days)
    ref = res_sync.auc_per_day
    rows.append(csv_row("fig6.from_sync.sync", 0.0,
                        f"first={ref[0]:.4f};avg={np.mean(ref):.4f}"))

    from_results = {}
    for mode in MODES:
        _, res = run_continual(base, CFG, stream, [mode] * eval_days,
                               setups, spec, eval_batches=16,
                               start_day=base_days)
        from_results[mode] = res.auc_per_day
        rows.append(csv_row(
            f"fig6.from_sync.{mode}", 0.0,
            f"first={res.auc_per_day[0]:.4f};"
            f"avg={np.mean(res.auc_per_day):.4f};"
            f"drop_vs_sync={ref[0] - res.auc_per_day[0]:+.4f}"))

    # switching back: mode for eval_days then sync for eval_days
    for mode in MODES:
        p, _ = run_continual(base, CFG, stream, [mode] * eval_days,
                             setups, spec, eval_batches=16,
                             start_day=base_days)
        _, res_back = run_continual(p, CFG, stream, ["sync"] * eval_days,
                                    setups, spec, eval_batches=16,
                                    start_day=base_days + eval_days)
        rows.append(csv_row(
            f"fig6.to_sync.{mode}", 0.0,
            f"first={res_back.auc_per_day[0]:.4f};"
            f"avg={np.mean(res_back.auc_per_day):.4f}"))

    gba_first = from_results["gba"][0]
    best_base = max(np.mean(from_results[m]) for m in MODES if m != "gba")
    claims = (f"gba_first_day_gap={ref[0] - gba_first:+.4f};"
              f"gba_avg={np.mean(from_results['gba']):.4f};"
              f"best_baseline_avg={best_base:.4f};"
              f"gba_beats_baselines="
              f"{np.mean(from_results['gba']) >= best_base - 1e-4}")
    us = (time.perf_counter() - t0) * 1e6
    rows.append(csv_row("fig6.claims", us, claims))
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--switching", action="store_true",
                    help="the switching harness's rows instead of the "
                         "continual protocol's")
    ap.add_argument("--base-days", type=int, default=8)
    ap.add_argument("--eval-days", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = (run_switching(args.device) if args.switching else
            run(args.base_days, args.eval_days, device=args.device))
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
