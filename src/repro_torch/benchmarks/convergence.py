"""Theorems 1/2 (Eq. 2/4): error-floor scaling on a strongly-convex
problem.

Counterpart of ``benchmarks/bench_convergence.py``, numpy only: the same
rows for the same arguments.  We minimize F(w) = 0.5 c ||w - w*||^2 with
stochastic gradients of per-sample variance sigma^2, via (a) sync
aggregation of G samples and (b) GBA aggregation with the same global
batch under injected staleness.  Theory: floor = eta L sigma^2 / (2 c G);
doubling G must halve the sync floor, and GBA's floor with matched G must
sit near sync's.

    python -m repro_torch.benchmarks.convergence
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks import csv_row

C = 1.0
ETA = 0.05
SIGMA = 1.0
DIM = 16


def _floor(global_batch: int, staleness: int = 0, iota: int = 10,
           steps: int = 4000, seed: int = 0) -> float:
    """Average F(w)-F* over the tail of a long run."""
    rng = np.random.default_rng(seed)
    w = np.ones(DIM)
    history = [w.copy()]
    vals = []
    for k in range(steps):
        src = history[max(0, len(history) - 1 - staleness)]
        # mean of G per-sample gradients: c*(w_src) + noise/sqrt(G)
        g = C * src + SIGMA * rng.normal(size=DIM) / np.sqrt(global_batch)
        if staleness > iota:
            g = np.zeros(DIM)  # Eq. (1) drops it
        w = w - ETA * g
        history.append(w.copy())
        if len(history) > 64:
            history.pop(0)
        if k > steps // 2:
            vals.append(0.5 * C * float(w @ w))
    return float(np.mean(vals))


def run() -> list[str]:
    t0 = time.perf_counter()
    rows = []
    floors = {}
    for g in (64, 128, 256, 512):
        floors[g] = _floor(g)
        rows.append(csv_row(f"thm.sync_floor.G{g}", 0.0,
                            f"floor={floors[g]:.3e}"))
    # floor ~ 1/G: ratio of successive floors ~ 0.5
    ratios = [floors[g2] / floors[g1] for g1, g2 in
              [(64, 128), (128, 256), (256, 512)]]
    rows.append(csv_row(
        "thm.floor_scales_inverse_G", 0.0,
        f"ratios={'|'.join(f'{r:.2f}' for r in ratios)};"
        f"expected=0.50;"
        f"pass={all(0.3 < r < 0.75 for r in ratios)}"))

    # GBA with staleness <= iota keeps ~the sync floor at matched G
    sync256 = floors[256]
    for stale in (0, 2, 4):
        f = _floor(256, staleness=stale, seed=stale + 1)
        rows.append(csv_row(
            f"thm.gba_floor.stale{stale}", 0.0,
            f"floor={f:.3e};vs_sync={f / sync256:.2f}"))
    us = (time.perf_counter() - t0) * 1e6
    rows.append(csv_row("thm.done", us, "see_EXPERIMENTS.md"))
    return rows


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    rows = run()
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
