"""Beyond-paper ablation: staleness-decay strategies under heavy staleness.

Counterpart of ``benchmarks/bench_decay_ablation.py``.  The paper uses the
hard threshold (Eq. 1) and notes other strategies are possible.  We
compare threshold / exponential / linear / no-decay on a GBA run over a
badly-strained cluster (deep staleness tail), measuring AUC after
switching from a sync base.  The base model starts from the reference's
draw of ``jax.random.PRNGKey(0)`` (``jax_init_recsys``).

    python -m repro_torch.benchmarks.decay_ablation [--base-days 6] \\
        [--device cuda]
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Any

import torch

from repro_torch.benchmarks import csv_row
from repro_torch.configs.recsys import CRITEO_DEEPFM
from repro_torch.convert import jax_init_recsys
from repro_torch.core import (DECAY_FNS, GBATrainer, default_setups,
                              evaluate, run_continual)
from repro_torch.data import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim import get_optimizer
from repro_torch.sim.cluster import ClusterSpec, Schedule, Slot, simulate

CFG = CRITEO_DEEPFM


def _reweighted(sched: Schedule, strategy: str, iota: int) -> Schedule:
    """``sched`` with every slot's weight recomputed from its token by
    ``strategy`` (``"none"``: weight 1)."""
    steps = []
    for k, slots in enumerate(sched.steps):
        new = []
        for s in slots:
            w = (float(DECAY_FNS[strategy](
                torch.tensor([s.token], dtype=torch.int32), k, iota)[0])
                if strategy != "none" else 1.0)
            new.append(Slot(s.batch_index, s.token, s.dispatch_step, w))
        steps.append(new)
    return Schedule("gba", 128, steps)


def run(base_days: int = 6, *, device: str | torch.device = "cuda",
        params: Any = None) -> list[str]:
    """The bench's rows.  The base model is the reference's draw of seed
    0 on ``device``, unless ``params`` (on ``device``) are given."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rows = []
    stream = make_clickstream(CFG, seed=0, batches_per_day=48,
                              batch_size=256, num_days=base_days + 3)
    setups = default_setups(base_global=2048)
    # very heavy strain -> deep staleness tail
    spec = ClusterSpec(num_workers=16, straggler_frac=0.4,
                       straggler_slowdown=12.0, jitter=0.3, seed=0)
    base = params if params is not None else jax_init_recsys(CFG, 0,
                                                             device=dev)
    base, _ = run_continual(base, CFG, stream, ["sync"] * base_days, setups,
                            spec, eval_batches=12)

    sched = simulate(replace(spec, seed=99), "gba", 768, 128,
                     buffer_size=16, iota=4)
    m = sched.metrics
    rows.append(csv_row("decay.scenario", 0.0,
                        f"avg_stale={m.avg_staleness:.2f};"
                        f"max_stale={m.staleness_max};"
                        f"drops={m.dropped_batches}"))

    day = base_days
    for strategy, iota in [("threshold", 4), ("exponential", 8),
                           ("linear", 8), ("none", 10**6)]:
        opt = get_optimizer("adam", 6e-4)
        trainer = GBATrainer(CFG, opt, iota=iota)
        p, _, _, _ = trainer.replay(base, opt.init(base),
                                    _reweighted(sched, strategy, iota),
                                    stream, day)
        auc = evaluate(p, CFG, stream, day + 1, 12)
        rows.append(csv_row(f"decay.{strategy}", 0.0, f"auc={auc:.4f}"))
    us = (time.perf_counter() - t0) * 1e6
    rows.append(csv_row("decay.done", us, "see EXPERIMENTS.md"))
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-days", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.base_days, device=args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
