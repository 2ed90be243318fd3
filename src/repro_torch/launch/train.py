"""Training launcher of the port: the LM's fused GBA step and the
sparse-module smoke.

    python -m repro_torch.launch.train --arch granite-8b --fused \\
        [--reduced] [--steps 20] [--batch 4] [--seq 128] [--buffer 4] \\
        [--iota 4] [--lr 1e-3] [--device cuda]
    python -m repro_torch.launch.train --vocab 1000000 --steps 5 \\
        [--embed-dim 16] [--batch 4] [--lr 1e-3] [--device cuda]

``--arch`` trains the LM with the fused flat-buffer GBA step
(``repro_torch.launch.programs``): per microstep the LM loss and its
gradient into the (M, N) buffer, and on every M-th microstep one
``gba_apply`` launch (Eq. (1) weights and Adagrad) over the flat params.
Microstep ``i`` carries the token ``i // M``, as in ``repro.launch.train``.
The port has only this Adagrad path, so ``--arch`` needs ``--fused`` (the
reference's ``--fused`` forces Adagrad too); ``--reduced`` takes the
config's smoke variant.  The reference's ``--mesh``, ``--compress``,
``--autoswitch`` and ``--host-devices`` are not ported.

``--vocab`` is the counterpart of ``run_embedding_smoke`` in
``repro.launch.train``: a ``--vocab``-row hashed table trained end to end
through the pooled lookup, whose forward is the ``embedding_bag`` kernel
and whose backward is the ``embedding_bag_grad`` kernel, one launch of
each per step.  The loss is the JAX smoke's: the stable binary
cross-entropy of ``pooled.sum(-1)``.  Raw ids and labels come from a
seeded ``torch.Generator`` instead of ``jax.random``, so the values differ
from the JAX run while the shapes and semantics match.  The JAX launcher's
block-size flags sized TPU VMEM blocks and are not ported.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import GBAConfig, ModelConfig
from repro_torch.data.lm import make_lm_stream
from repro_torch.embeddings.table import (EmbeddingTable, hash_ids,
                                          init_table, pooled_lookup)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.programs import build_programs
from repro_torch.models import transformer as T

NUM_FIELDS = 26


@dataclass(frozen=True)
class SmokeStep:
    """What one step of the smoke computed, for a caller's checks."""
    step: int
    ids: torch.Tensor          # (batch, NUM_FIELDS) int32 hashed ids
    labels: torch.Tensor       # (batch,) float32
    table: torch.Tensor        # (vocab, dim) the table the step looked up
    pooled: torch.Tensor       # (batch, dim) the pooled lookup
    loss: float
    pooled_grad: torch.Tensor  # (batch, dim) d loss / d pooled
    table_grad: torch.Tensor   # (vocab, dim) d loss / d table


def _bce(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * labels
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def run_embedding_smoke(vocab: int, *, steps: int = 20, embed_dim: int = 16,
                        batch: int = 4, lr: float = 1e-3,
                        device: str | torch.device = "cuda",
                        on_step: Callable[[SmokeStep], None] | None = None,
                        log: Callable[[str], None] = print) -> list[float]:
    """Train a (vocab, embed_dim) table for ``steps`` steps of plain SGD on
    batches of ``batch`` bags of 26 hashed ids; returns the losses.
    ``on_step``, if given, sees each step's inputs, pooled lookup and
    gradients.
    Raises if a loss is not finite."""
    dev = resolve_device(device)
    tbl = init_table(vocab, embed_dim,
                     generator=torch.Generator().manual_seed(0), device=dev)
    log(f"embedding smoke: V={vocab:,} D={embed_dim} "
        f"table={vocab * embed_dim * 4 / 1e6:.0f}MB on {dev}")
    table = tbl.table
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        gen = torch.Generator().manual_seed(1000 + i)
        raw = torch.randint(0, 1 << 30, (batch, NUM_FIELDS), generator=gen)
        labels = (torch.rand((batch,), generator=gen) < 0.5).float().to(dev)
        ids = hash_ids(raw, vocab).to(dev)
        table = table.detach().requires_grad_()
        pooled = pooled_lookup(EmbeddingTable(table, tbl.last_update), ids)
        loss = _bce(pooled.sum(dim=-1), labels)
        table_grad, pooled_grad = torch.autograd.grad(loss, (table, pooled))
        looked_up, table = table.detach(), (table - lr * table_grad).detach()
        losses.append(loss.item())
        if on_step is not None:
            on_step(SmokeStep(i, ids, labels, looked_up, pooled.detach(),
                              losses[-1], pooled_grad, table_grad))
        rate = (i + 1) * batch * NUM_FIELDS / (time.perf_counter() - t0)
        log(f"step {i:4d}  loss {losses[-1]:.4f}  {rate:,.0f} lookups/s")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"embedding smoke diverged: losses {losses}")
    return losses


def run_lm_fused(cfg: ModelConfig, *, steps: int = 20, batch: int = 4,
                 seq: int = 128, buffer: int = 4, iota: int = 4,
                 lr: float = 1e-3, device: str | torch.device = "cuda"
                 ) -> list[float]:
    """Train ``cfg`` for ``steps`` microsteps of the fused GBA step on the
    LM stream (seed 0); returns the losses.  Parameters are drawn from
    seed 0 on the device.  Raises if a loss is not finite."""
    dev = resolve_device(device)
    params = T.init_model(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
    gba = GBAConfig(local_batch=batch, buffer_size=buffer,
                    staleness_tolerance=iota)
    progs = build_programs(cfg, gba, params=params, mode="fused", lr=lr)
    del params
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    print(f"{cfg.name}: {T.param_count(progs.state['params']) / 1e6:.1f}M "
          f"params on {dev}")
    print(f"fused gba_apply path (Adagrad): flat buffer ({buffer}, "
          f"{progs.layout.total})")
    state, losses = progs.state, []
    t0 = time.perf_counter()
    for i in range(steps):
        b = stream.batch(i)
        tensors = {k: torch.from_numpy(b[k]).to(dev)
                   for k in ("tokens", "labels")}
        state, loss = progs.step(state, tensors, i // buffer)
        losses.append(loss.item())
        if i % 5 == 0 or i == steps - 1:
            rate = (i + 1) * batch * seq / (time.perf_counter() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  gstep "
                  f"{state['buffer']['step']}  {rate:,.0f} tok/s")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"LM training diverged: losses {losses}")
    return losses


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS,
                    help="LM architecture (granite-8b is ported)")
    ap.add_argument("--vocab", type=int, default=0,
                    help="rows of the hashed table of the sparse smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--buffer", type=int, default=4, help="GBA M")
    ap.add_argument("--iota", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke variant")
    ap.add_argument("--fused", action="store_true",
                    help="flat-buffer GBA with the fused gba_apply kernel "
                         "(Adagrad); the only LM path of the port")
    ap.add_argument("--embed-dim", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch:
        if not args.fused:
            ap.error("--arch: the port has only the fused flat-buffer "
                     "Adagrad step; pass --fused")
        try:
            cfg = get_config(args.arch)
        except NotImplementedError as e:
            ap.error(str(e))
        return run_lm_fused(cfg.reduced() if args.reduced else cfg,
                            steps=args.steps, batch=args.batch,
                            seq=args.seq, buffer=args.buffer,
                            iota=args.iota, lr=args.lr, device=args.device)
    if args.vocab <= 0:
        ap.error("--arch or --vocab N is required")
    return run_embedding_smoke(args.vocab, steps=args.steps,
                               embed_dim=args.embed_dim, batch=args.batch,
                               lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
