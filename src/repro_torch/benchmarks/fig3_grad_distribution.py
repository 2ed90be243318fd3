"""Paper Fig. 3 / Insight 1: the distribution of aggregated-gradient L2
norms is governed by the *aggregation size*, not by the training mode.

Counterpart of ``benchmarks/bench_fig3_grad_distribution.py``.  We
compute dense-module gradient norms for:
  sync with N_s x B_s   (global batch G)
  BSP-G  (async aggregation of M = G/B_a gradients -> same G)
  BSP-half (aggregation size G/2)
  async  (single local batch B_a)

Claim validated when |mean(BSP-G) - mean(sync)| << |mean(async) -
mean(sync)| and the same for BSP-half.  The model starts from the
reference's draw of ``jax.random.PRNGKey(0)`` (``jax_init_recsys``).

    python -m repro_torch.benchmarks.fig3_grad_distribution \\
        [--n-samples 24] [--device cuda]
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
from torch.func import grad

from repro_torch.benchmarks import csv_row
from repro_torch.configs.recsys import CRITEO_DEEPFM
from repro_torch.convert import jax_init_recsys
from repro_torch.core import EMBED_KEYS
from repro_torch.data import make_clickstream
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import recsys as R
from repro_torch.optim import get_optimizer, tree_leaves, tree_map

CFG = CRITEO_DEEPFM


def _dense_norm(grads) -> float:
    dense = {k: v for k, v in grads.items() if k not in EMBED_KEYS}
    return float(torch.sqrt(sum(torch.sum(torch.square(x))
                                for x in tree_leaves(dense))))


def run(n_samples: int = 24, *, device: str | torch.device = "cuda",
        params: Any = None) -> list[str]:
    """The bench's rows.  The model is the reference's draw of seed 0 on
    ``device``, unless ``params`` (on ``device``) are given."""
    dev = resolve_device(device)
    stream = make_clickstream(CFG, seed=0, batch_size=256)

    def batch(day: int, index: int) -> dict:
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch(day, index).items()}

    if params is None:
        params = jax_init_recsys(CFG, 0, device=dev)
    # briefly train so gradients are not at the init saddle
    opt = get_optimizer("adam", 1e-3)
    state = opt.init(params)
    grad_fn = grad(lambda p, b: R.bce_loss(p, CFG, b))
    for i in range(20):
        params, state = opt.update(params, grad_fn(params, batch(0, i)),
                                   state)

    t0 = time.perf_counter()

    def agg_norms(agg_size: int, count: int, tag: int) -> np.ndarray:
        out = []
        for j in range(count):
            gs = [grad_fn(params, batch(1, tag * 10_000 + j * agg_size + i))
                  for i in range(agg_size)]
            mean = tree_map(lambda *x: sum(x) / agg_size, *gs)
            out.append(_dense_norm(mean))
        return np.array(out)

    G = 8  # aggregation size in local batches (G*256 samples)
    sync = agg_norms(G, n_samples, 0)
    bsp_match = agg_norms(G, n_samples, 1)
    bsp_half = agg_norms(G // 2, n_samples, 2)
    async_ = agg_norms(1, n_samples, 3)
    us = (time.perf_counter() - t0) * 1e6 / (4 * n_samples)

    gap_match = abs(bsp_match.mean() - sync.mean())
    gap_half = abs(bsp_half.mean() - sync.mean())
    gap_async = abs(async_.mean() - sync.mean())
    ok = gap_match < gap_half < gap_async
    return [
        csv_row("fig3.grad_norm.sync_G", us,
                f"mean={sync.mean():.4f};std={sync.std():.4f}"),
        csv_row("fig3.grad_norm.bsp_same_G", us,
                f"mean={bsp_match.mean():.4f};std={bsp_match.std():.4f}"),
        csv_row("fig3.grad_norm.bsp_half_G", us,
                f"mean={bsp_half.mean():.4f};std={bsp_half.std():.4f}"),
        csv_row("fig3.grad_norm.async_B", us,
                f"mean={async_.mean():.4f};std={async_.std():.4f}"),
        csv_row("fig3.claim_same_G_same_distribution", us,
                f"validated={ok};gap_G={gap_match:.4f};"
                f"gap_halfG={gap_half:.4f};gap_async={gap_async:.4f}"),
    ]


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-samples", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.n_samples, device=args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
