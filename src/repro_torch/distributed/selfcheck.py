"""Hold the process-group backend of the wire step to the in-process one,
bit for bit.

:func:`compare` runs the worker-parallel wire step
(``repro_torch.core.gba_shard_map``) for each scheme (``none``, ``int8``,
``onebit``), ``STEPS`` global steps with ``WARMUP`` float32 warmup step,
first on R ranks (``process_group.spawn``: gloo on the CPU, NCCL one rank
per card on ``cuda``), each rank running :func:`run`, which saves its run
of the params and the accumulator, its wire rows and the losses, then
with every worker in this process (``inprocess``); and counts the
elements whose bits differ.  :func:`run` is the ranks' entry function,
here because a spawned process cannot import a test module.

The problem makes every gradient exact, so the comparison does not hang
on the order of a library's sums: leaves that are not tile multiples in 3
layer groups, tile 256; the loss is ``mean(x) * sum of squares`` with
``x`` in multiples of 1/8 and the squares folded in halves, element by
element; worker 2 is three steps stale, which Eq. (1) drops at iota 2.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.core.compression import SCHEMES, CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.gba_shard_map import make_gba_fused_psum_step
from repro_torch.distributed import inprocess, process_group

TILE, IOTA, LR, STEPS, WARMUP = 256, 2, 0.05, 3, 1
ROWS_PER_WORKER = 8
SHAPES = {"embed": (33, 9), "blocks": {"l0": {"w": (41,), "b": (7, 5)}},
          "head": (700,)}


def problem(workers: int, seed: int = 7) -> tuple[dict, torch.Tensor]:
    """The params (float32 normal draws of ``SHAPES``) and the ``(STEPS,
    ROWS_PER_WORKER * workers)`` inputs, on the CPU."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    params = draw(SHAPES)
    n = (STEPS, ROWS_PER_WORKER * workers)
    x = rng.integers(1, 17, n) * rng.choice([-1.0, 1.0], n) / 8
    return params, torch.from_numpy(x.astype(np.float32))


def _fold(v: torch.Tensor) -> torch.Tensor:
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = torch.cat([v, v.new_zeros(n - v.shape[0])])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def loss_fn(params, batch: dict) -> torch.Tensor:
    s = None
    for _, leaf in tree_paths(params):
        f = leaf.float().reshape(-1)
        s = _fold(f * f) if s is None else s + _fold(f * f)
    return batch["x"].mean() * s


def tokens(step: int, workers: int) -> list[int]:
    """Every worker's token at global step ``step``: the step, worker 2's
    three steps old."""
    return [step - 3 if w == 2 else step for w in range(workers)]


def run(world, device: torch.device, workers: int, schemes: tuple,
        out_dir: str) -> None:
    """Run every scheme's ``STEPS`` global steps over ``world`` on
    ``device`` and save what this process holds, on the CPU, to
    ``out_dir/part<first worker>.pt``: per scheme its run of ``param``
    and ``accum``, its wire rows and every ``loss``."""
    params, xs = problem(workers)
    layout = ShardedFlatLayout.from_params(params, workers, tile=TILE,
                                           group_by=lambda path: path[0])
    mine = world.workers(workers)
    ss = layout.shard_size
    held = {}
    for scheme in schemes:
        pol = CompressionPolicy(scheme=scheme, warmup_steps=WARMUP)
        warm, comp = (make_gba_fused_psum_step(
            workers, loss_fn, layout, iota=IOTA, lr=LR, compress=pol,
            warm=w, world=world) for w in (True, False))
        pf = layout.ravel(params)[mine[0] * ss:(mine[-1] + 1) * ss].to(
            device, copy=True)
        af = torch.full_like(pf, 0.1)
        wire = (pol.init_wire_state(layout, len(mine), device)
                if pol.stateful else None)
        losses = []
        for t in range(STEPS):
            batch = {"x": xs[t].to(device)}
            toks = torch.tensor(tokens(t, workers), dtype=torch.int32,
                                device=device)
            step = warm if t < WARMUP else comp
            if wire is None:
                pf, af, loss = step(pf, af, batch, toks, t)
            else:
                pf, af, loss, wire = step(pf, af, batch, toks, t, wire)
            losses.append(loss)
        held[scheme] = {"param": pf.cpu(), "accum": af.cpu(),
                        "loss": torch.stack(losses).cpu(),
                        **{k: v.cpu() for k, v in (wire or {}).items()}}
    torch.save(held, os.path.join(out_dir, f"part{mine[0]}.pt"))


def compare(ranks: int, workers: int = 4, schemes: tuple = SCHEMES,
            device: str = "cuda", timeout: float = 600.0) -> dict:
    """``{scheme: {name: elements whose bits differ}}`` between the wire
    step on ``ranks`` ranks and in process, for ``param``, ``accum``,
    ``loss`` (every rank's) and each wire state."""
    dev = process_group.check_world(ranks, workers, device)
    with tempfile.TemporaryDirectory() as tmp:
        dist_dir, local_dir = (os.path.join(tmp, d) for d in ("dist", "in"))
        os.mkdir(dist_dir)
        os.mkdir(local_dir)
        process_group.spawn(run, ranks, workers, tuple(schemes), dist_dir,
                            device=dev.type, timeout=timeout)
        run(inprocess, dev, workers, tuple(schemes), local_dir)
        k = workers // ranks
        parts = [torch.load(os.path.join(dist_dir, f"part{r * k}.pt"))
                 for r in range(ranks)]
        want = torch.load(os.path.join(local_dir, "part0.pt"))
    report = {}
    for scheme, ref in want.items():
        report[scheme] = {}
        for name, v in ref.items():
            got = ([p[scheme][name] for p in parts] if name == "loss"
                   else [torch.cat([p[scheme][name] for p in parts])])
            report[scheme][name] = max(
                int((g.view(torch.int32) != v.view(torch.int32)).sum())
                if g.shape == v.shape else v.numel() for g in got)
    return report

