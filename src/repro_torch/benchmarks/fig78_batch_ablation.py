"""Paper Figs. 7/8: the batch-geometry ablations.

Counterpart of ``benchmarks/bench_fig78_batch_ablation.py``.

Fig. 7: keep the global batch fixed, vary the worker count (and with it
the local batch): AUC must stay flat (abs diff ~1e-3 at our scale) while
simulated QPS scales with workers.

Fig. 8: fix the workers, vary the local batch so the *global* batch
diverges from the sync reference: AUC after switching degrades relative
to matched-G GBA.

The base model starts from the reference's draw of
``jax.random.PRNGKey(0)`` (``jax_init_recsys``).

    python -m repro_torch.benchmarks.fig78_batch_ablation \\
        [--base-days 5] [--eval-days 2] [--device cuda]
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.benchmarks import csv_row
from repro_torch.configs.recsys import CRITEO_DEEPFM
from repro_torch.convert import jax_init_recsys
from repro_torch.core import ModeSetup, default_setups, run_continual
from repro_torch.data import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim.cluster import ClusterSpec

CFG = CRITEO_DEEPFM
G = 2048  # the sync-matched global batch


def run(base_days: int = 5, eval_days: int = 2, *,
        device: str | torch.device = "cuda", params: Any = None
        ) -> list[str]:
    """The bench's rows.  The base model is the reference's draw of seed
    0 on ``device``, unless ``params`` (on ``device``) are given."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    stream = make_clickstream(CFG, seed=0, batches_per_day=48,
                              batch_size=256,
                              num_days=base_days + eval_days + 2)
    setups = default_setups(base_global=G)
    spec = ClusterSpec(num_workers=16, straggler_frac=0.25,
                       straggler_slowdown=5.0, jitter=0.2, seed=0)
    base = params if params is not None else jax_init_recsys(CFG, 0,
                                                             device=dev)
    base, _ = run_continual(base, CFG, stream, ["sync"] * base_days, setups,
                            spec, eval_batches=8)

    rows = []
    # Fig. 7: same G, vary workers M (local batch = G / M)
    fig7 = {}
    for m in (8, 16, 32):
        setups_m = dict(setups)
        setups_m["gba"] = ModeSetup("gba", m, G // m, buffer_size=m, iota=4)
        _, res = run_continual(base, CFG, stream, ["gba"] * eval_days,
                               setups_m, spec, eval_batches=8,
                               start_day=base_days)
        fig7[m] = (np.mean(res.auc_per_day), np.mean(res.qps_per_day))
        rows.append(csv_row(f"fig7.workers_{m}", 0.0,
                            f"auc={fig7[m][0]:.4f};qps={fig7[m][1]:.0f}"))
    aucs = [v[0] for v in fig7.values()]
    qpss = [v[1] for v in fig7.values()]
    rows.append(csv_row(
        "fig7.claims", 0.0,
        f"auc_spread={max(aucs) - min(aucs):.4f};"
        f"qps_scaling={qpss[-1] / qpss[0]:.2f}x;"
        f"steady_auc={'PASS' if max(aucs) - min(aucs) < 0.01 else 'FAIL'}"))

    # Fig. 8: fixed workers=16, vary local batch (G changes)
    fig8 = {}
    for lb in (32, 64, G // 16, 512):
        setups_b = dict(setups)
        setups_b["gba"] = ModeSetup("gba", 16, lb, buffer_size=16, iota=4)
        _, res = run_continual(base, CFG, stream, ["gba"] * eval_days,
                               setups_b, spec, eval_batches=8,
                               start_day=base_days)
        fig8[lb] = np.mean(res.auc_per_day)
        rows.append(csv_row(
            f"fig8.local_batch_{lb}", 0.0,
            f"global_batch={lb * 16};auc={fig8[lb]:.4f};"
            f"matched={'yes' if lb * 16 == G else 'no'}"))
    matched = fig8[G // 16]
    larger = min(v for k, v in fig8.items() if k * 16 > G)
    smaller = max(v for k, v in fig8.items() if k * 16 < G)
    us = (time.perf_counter() - t0) * 1e6
    # pre-plateau, a smaller G trains faster (more optimizer steps); the
    # paper's Fig. 8 regime is a converged base, where matched-G wins
    # outright: the claim is the unambiguous direction (a larger
    # mismatched G under the sync-tuned LR is worse), and the smaller-G
    # side is reported
    rows.append(csv_row(
        "fig8.claims", us,
        f"matched_auc={matched:.4f};larger_G_auc={larger:.4f};"
        f"smaller_G_auc={smaller:.4f};"
        f"matched_beats_larger={'PASS' if matched >= larger else 'FAIL'}"))
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-days", type=int, default=5)
    ap.add_argument("--eval-days", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.base_days, args.eval_days, device=args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
