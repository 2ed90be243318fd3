"""Quickstart: train DeepFM with GBA on a synthetic click stream.

    python -m repro_torch.launch.quickstart [--device cuda] [--days 4]

Counterpart of ``examples/quickstart.py``, with the same configuration,
stream, schedule and table:

  1. build a Criteo-like stream and a DeepFM model (``CRITEO_DEEPFM``:
     100,003 x 16 embeddings, 26 fields, MLP 416 -> 256 -> 128 -> 64 -> 1);
  2. simulate a strained shared cluster (16 workers at local batch 128,
     25 % stragglers at 5x, jitter 0.2) to get a GBA schedule (M = 16,
     iota 4) over 256 batches a day;
  3. replay it with real gradients and Adam at lr 1e-3 (parameter-server
     staleness semantics);
  4. evaluate AUC on the next day over 8 batches.

Parameters are drawn from ``torch.Generator().manual_seed(0)``, not from
the JAX package's key, so the AUCs are close to the JAX quickstart's but
not equal.  Every global step launches the ``embedding_bag_grad`` kernel
once (the per-slot presence counts) on a CUDA device.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.recsys import CRITEO_DEEPFM, RecsysConfig
from repro_torch.core.continual import ModeSetup, schedule_for_day
from repro_torch.core.trainer import GBATrainer, ReplayStats, evaluate
from repro_torch.data.clickstream import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.recsys import init_recsys
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.sim.cluster import ClusterSpec

SETUP = ModeSetup("gba", num_workers=16, local_batch=128, buffer_size=16,
                  iota=4)
SPEC = ClusterSpec(num_workers=16, straggler_frac=0.25,
                   straggler_slowdown=5.0, jitter=0.2, seed=0)
NUM_BATCHES = 256
EVAL_BATCHES = 8
LR = 1e-3


@dataclass
class DayRow:
    day: int
    auc: float
    qps: float
    drops: int
    steps: int
    stats: ReplayStats
    seconds: float       # host clock: the day's replay and its evaluation


@dataclass
class QuickstartResult:
    params: Any
    rows: list[DayRow] = field(default_factory=list)


def make_trainer(cfg: RecsysConfig = CRITEO_DEEPFM) -> GBATrainer:
    """The quickstart's trainer: Adam at ``LR``, tolerance ``SETUP.iota``."""
    return GBATrainer(cfg, get_optimizer("adam", LR), iota=SETUP.iota)


def run(params: Any, cfg: RecsysConfig = CRITEO_DEEPFM, *, days: int = 4,
        log: Callable[[str], None] = print) -> QuickstartResult:
    """Train ``params`` (on their device) for ``days`` days of the
    quickstart's GBA schedule, evaluating each day on the next; logs the
    table of day / auc / qps / drops / steps."""
    stream = make_clickstream(cfg, seed=0, batch_size=SETUP.local_batch)
    trainer = make_trainer(cfg)
    opt_state = trainer.optimizer.init(params)
    last_update = None
    result = QuickstartResult(params)
    log(f"{'day':>3} {'auc':>8} {'qps':>10} {'drops':>6} {'steps':>6}")
    for day in range(days):
        t0 = time.perf_counter()
        sched = schedule_for_day(SETUP, SPEC, num_batches=NUM_BATCHES)
        params, opt_state, last_update, stats = trainer.replay(
            params, opt_state, sched, stream, day, last_update=last_update)
        auc = evaluate(params, cfg, stream, day + 1,
                       num_batches=EVAL_BATCHES)
        m = sched.metrics
        result.rows.append(DayRow(day, auc, m.qps, m.dropped_batches,
                                  m.num_global_steps, stats,
                                  time.perf_counter() - t0))
        log(f"{day:>3} {auc:>8.4f} {m.qps:>10.0f} "
            f"{m.dropped_batches:>6} {m.num_global_steps:>6}")
    result.params = params
    return result


def main(argv: list[str] | None = None) -> QuickstartResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--days", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_recsys(CRITEO_DEEPFM,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)
    result = run(params, CRITEO_DEEPFM, days=args.days)
    print("done — GBA trained at async speed with sync-like accuracy.")
    return result


if __name__ == "__main__":
    main()
