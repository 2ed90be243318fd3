"""Paper Tab. 5.1's other two tasks: Alimama/DIEN and Private/YouTubeDNN.

Counterpart of ``benchmarks/bench_multitask.py``.  The headline claim
(C2: switching sync->GBA is tuning-free and matches continued sync) must
hold on all three model families: DeepFM is covered by Fig. 6; this
bench runs the GRU-attention DIEN tower and the two-tower YouTubeDNN on
their own synthetic behaviour streams.  Each base model starts from the
reference's draw of ``jax.random.PRNGKey(0)`` (``jax_init_recsys``).

    python -m repro_torch.benchmarks.multitask [--base-days 6] \\
        [--eval-days 2] [--device cuda]
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.benchmarks import csv_row
from repro_torch.configs.recsys import ALIMAMA_DIEN, PRIVATE_YOUTUBEDNN
from repro_torch.convert import jax_init_recsys
from repro_torch.core import default_setups, run_continual
from repro_torch.data import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.sim.cluster import ClusterSpec

CONFIGS = (ALIMAMA_DIEN, PRIVATE_YOUTUBEDNN)


def run(base_days: int = 6, eval_days: int = 2, *,
        device: str | torch.device = "cuda",
        params: dict[str, Any] | None = None) -> list[str]:
    """The bench's rows.  ``params`` maps a config's name to its base
    model on ``device``; a config it does not name starts from the
    reference's draw of seed 0."""
    dev = resolve_device(device)
    rows = []
    t0 = time.perf_counter()
    spec = ClusterSpec(num_workers=16, straggler_frac=0.25,
                       straggler_slowdown=5.0, jitter=0.2, seed=0)
    setups = default_setups(base_global=2048)
    for cfg in CONFIGS:
        stream = make_clickstream(cfg, seed=0, batches_per_day=48,
                                  batch_size=256,
                                  num_days=base_days + eval_days + 2)
        base = (params or {}).get(cfg.name)
        if base is None:
            base = jax_init_recsys(cfg, 0, device=dev)
        base, res0 = run_continual(base, cfg, stream, ["sync"] * base_days,
                                   setups, spec, eval_batches=12)
        _, res_sync = run_continual(base, cfg, stream, ["sync"] * eval_days,
                                    setups, spec, eval_batches=12,
                                    start_day=base_days)
        _, res_gba = run_continual(base, cfg, stream, ["gba"] * eval_days,
                                   setups, spec, eval_batches=12,
                                   start_day=base_days)
        gap = res_sync.auc_per_day[0] - res_gba.auc_per_day[0]
        rows.append(csv_row(
            f"multitask.{cfg.name}", 0.0,
            f"base_auc={res0.auc_per_day[-1]:.4f};"
            f"sync_first={res_sync.auc_per_day[0]:.4f};"
            f"gba_first={res_gba.auc_per_day[0]:.4f};"
            f"first_day_gap={gap:+.4f};"
            f"gba_avg={np.mean(res_gba.auc_per_day):.4f};"
            f"sync_avg={np.mean(res_sync.auc_per_day):.4f};"
            f"tuning_free={'PASS' if abs(gap) < 0.01 else 'FAIL'}"))
    us = (time.perf_counter() - t0) * 1e6
    rows.append(csv_row("multitask.done", us, "3_of_3_tasks_covered"))
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-days", type=int, default=6)
    ap.add_argument("--eval-days", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.base_days, args.eval_days, device=args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
