"""Training launcher of the port: the LM's pytree GBA step, its fused
flat-buffer step, its worker-parallel wire step, and the sparse-module
smoke.

    python -m repro_torch.launch.train --arch granite-8b [--fused] \\
        [--reduced] [--steps 20] [--batch 4] [--seq 128] [--buffer 4] \\
        [--iota 4] [--lr 1e-3] [--device cuda]
    python -m repro_torch.launch.train --arch granite-8b --fused \\
        --mesh 4x1 [--compress {none,int8,onebit}] [--compress-warmup 2] \\
        [--layer-groups {on,off}] [--ranks R] [--reduced] [--steps 20] ...
    python -m repro_torch.launch.train --arch granite-8b --mesh 4x1 \\
        --autoswitch [--plan {quiet,strained}] [--batches 120] [--ranks R] \\
        [--reduced]
    python -m repro_torch.launch.train --vocab 1000000 --steps 5 \\
        [--embed-dim 16] [--batch 4] [--lr 1e-3] [--device cuda]

``--arch`` trains the LM with the pytree GBA step, the reference
launcher's default (``repro_torch.launch.programs``, ``mode="pytree"``):
per microstep the LM loss and its gradient, added into a per-leaf
accumulator with its Eq. (1) weight over M, and on every M-th microstep
the arch's optimizer (``ARCH_OPTIMIZER``: Adam for granite-8b) applies
it.  With ``--fused`` it trains with the fused flat-buffer step instead:
per microstep the gradient into the (M, N) buffer, and on every M-th
microstep one ``gba_apply`` launch (Eq. (1) weights and Adagrad) over the
flat params; ``--fused`` forces Adagrad, as in the reference.  Microstep
``i`` carries the token ``i // M``, as in ``repro.launch.train``.
``--reduced`` takes the config's smoke variant.

``--fused --mesh Wx1`` (``--compress none``, the default) runs the
reference's sharded fused step (``run_lm_fused`` with W workers): the
microsteps of ``--fused``, with the flat buffer and the Adagrad
accumulator split into W tile-aligned PS shards, layer-grouped unless
``--layer-groups off``, and on every M-th microstep one ``gba_apply``
launch per shard.  ``--compress int8`` or ``onebit`` runs the
worker-parallel wire step instead (``run_wire_train``), W PS workers, each
also a PS shard, in one process on the one device: every step is a
global step in which each worker takes the gradient of its own ``batch /
W`` sequences and routes it per layer group to the shards, quantized
after ``--compress-warmup`` float32 global steps, and each shard applies
with one ``gba_apply`` launch.  ``--ranks R`` runs either step on R
``torch.distributed`` ranks (``repro_torch.distributed.process_group``):
gloo with ``--device cpu``, NCCL on R cards with ``cuda``.  The wire step
puts W / R workers on each rank; the sharded fused step splits each
microstep's ``--batch`` over the ranks, reduce-scatters the gradient
into the W / R shards each rank owns and gathers the params after each
apply.  A gloo rank runs as many intra-op threads as the launching
process, so a worker's CPU matmuls round as they do without ``--ranks``
(the ranks then share the cores R times over).  A model axis above 1 is
not ported.

``--mesh Wx1 --autoswitch`` runs the switching harness
(``repro_torch.launch.switch_driver``) on the arch's steps
(``run_autoswitch``): the pytree sync step with Adagrad and the
token-controlled worker-parallel async step, W workers with ``--batch``
sequences each, under the ``--plan`` fault plan, switching on live
telemetry over ``--batches`` local batches.  It needs no ``--fused`` and 2
or more workers; ``--ranks R`` runs it on R ranks of W / R workers each.
The reference's JAX-only ``--host-devices`` is not ported.

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
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.data.lm import make_lm_stream
from repro_torch.distributed import inprocess, process_group
from repro_torch.embeddings.table import (EmbeddingTable, hash_ids,
                                          init_table, pooled_lookup)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.programs import (ARCH_OPTIMIZER, TrainPrograms,
                                         build_programs, make_loss_fn)
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer

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


def run_lm_pytree(cfg: ModelConfig, *, optimizer: str = "adam",
                  steps: int = 20, batch: int = 4, seq: int = 128,
                  buffer: int = 4, iota: int = 4, lr: float = 1e-3,
                  device: str | torch.device = "cuda",
                  params: dict | None = None,
                  on_step: Callable[[int, TrainPrograms, float], None]
                  | None = None) -> list[float]:
    """Train ``cfg`` for ``steps`` microsteps of the pytree GBA step with
    ``optimizer`` (a name of ``repro_torch.optim``) at ``lr`` on the LM
    stream (seed 0); returns the losses.  Parameters are drawn from seed 0
    on the device unless ``params`` (on ``device``) are given;
    ``on_step(i, programs, seconds)``, if given, sees the programs after
    each microstep, ``programs.state`` the state the step returned, and
    the microstep's seconds on the host clock up to its loss on the host
    (which waits for the step's device work).  Raises if a loss is not
    finite."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_model(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    gba = GBAConfig(local_batch=batch, buffer_size=buffer,
                    staleness_tolerance=iota)
    progs = build_programs(cfg, gba, params=params, mode="pytree", lr=lr,
                           optimizer=get_optimizer(optimizer, lr))
    del params
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    print(f"{cfg.name}: {T.param_count(progs.state['params']) / 1e6:.1f}M "
          f"params on {dev}")
    print(f"pytree GBA path ({optimizer}): M={buffer}, iota={iota}, "
          f"float32 accumulator")
    state, losses = progs.state, []
    t0 = time.perf_counter()
    for i in range(steps):
        b = stream.batch(i)
        tensors = {k: torch.from_numpy(b[k]).to(dev)
                   for k in ("tokens", "labels")}
        t = time.perf_counter()
        state, loss = progs.step(state, tensors, i // buffer)
        losses.append(loss.item())
        progs.state = state
        if on_step is not None:
            on_step(i, progs, time.perf_counter() - t)
        if i % 5 == 0 or i == steps - 1:
            rate = (i + 1) * batch * seq / (time.perf_counter() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  gstep "
                  f"{state['gstep']}  {rate:,.0f} tok/s")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"LM training diverged: losses {losses}")
    return losses


def run_lm_fused(cfg: ModelConfig, *, steps: int = 20, batch: int = 4,
                 seq: int = 128, buffer: int = 4, iota: int = 4,
                 lr: float = 1e-3, workers: int = 1,
                 layer_groups: bool = True,
                 device: str | torch.device = "cuda",
                 world=inprocess) -> list[float]:
    """Train ``cfg`` for ``steps`` microsteps of the fused GBA step on the
    LM stream (seed 0), its flat state split into ``workers`` PS shards
    when there are 2 or more (layer-grouped unless ``layer_groups`` is
    False), the shards and each microstep's ``batch`` sequences spread
    over the ranks of ``world`` (all here by default); returns the
    losses.  Parameters are drawn from seed 0 on the device.  Raises if a
    loss is not finite."""
    dev = resolve_device(device)
    if batch % world.size:
        raise ValueError(f"{world.size} ranks must divide --batch {batch}")
    params = T.init_model(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
    gba = GBAConfig(local_batch=batch, buffer_size=buffer,
                    staleness_tolerance=iota)
    progs = build_programs(cfg, gba, params=params, mode="fused", lr=lr,
                           workers=workers, layer_groups=layer_groups,
                           world=world)
    del params
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    print(f"{cfg.name}: {T.param_count(progs.state['params']) / 1e6:.1f}M "
          f"params on {dev}")
    rows, mine = batch // world.size, world.workers(max(workers, 1))
    if world is not inprocess:
        print(f"process group: {world.backend}, {world.size} ranks x "
              f"{len(mine)} shards, {rows} sequences a rank a microstep")
    first = mine[0] // len(mine) * rows
    layout = progs.layout
    if isinstance(layout, ShardedFlatLayout):
        print(f"sharded fused gba_apply path (Adagrad): flat buffer "
              f"({buffer}, {layout.padded_total}) sliced over "
              f"data={layout.num_shards} (shard_size={layout.shard_size}, "
              f"tile={layout.tile}; 1 apply launch/shard vs "
              f"{len(layout.sizes)} per-leaf)")
        if layout.num_groups > 1:
            table = ", ".join(f"{r['key']}={r['bytes'] / 1e6:.2f}MB"
                              for r in layout.group_table())
            print(f"layer groups ({layout.num_groups}): {table}; "
                  f"peak_gather={layout.peak_gather_bytes / 1e6:.2f}MB vs "
                  f"full_gather={layout.full_gather_bytes / 1e6:.2f}MB")
    else:
        print(f"fused gba_apply path (Adagrad): flat buffer ({buffer}, "
              f"{layout.total})")
    state, losses = progs.state, []
    t0 = time.perf_counter()
    for i in range(steps):
        b = stream.batch(i)
        tensors = {k: torch.from_numpy(b[k][first:first + rows]).to(dev)
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


def run_wire_train(cfg: ModelConfig, *, workers: int, scheme: str,
                   steps: int = 20, batch: int = 4, seq: int = 128,
                   iota: int = 4, lr: float = 1e-3, compress_warmup: int = 2,
                   layer_groups: bool = True,
                   device: str | torch.device = "cuda",
                   params: dict | None = None,
                   on_step: Callable[[int, TrainPrograms], None] | None = None,
                   world=inprocess) -> list[float]:
    """Train ``cfg`` for ``steps`` global steps of the worker-parallel
    layer-grouped step, ``workers`` workers and shards over the
    collectives of ``world`` (all on the one device by default, or this
    rank's share under a ``process_group.ProcessGroupBackend``), with the
    ``scheme`` wire; returns the losses.

    Step ``i`` gives every worker the token ``i`` and is global step
    ``i``, as in the reference.  The first ``compress_warmup`` steps route
    float32, the rest the quantized wire.  ``params`` (on ``device``)
    replace the ones drawn from seed 0; ``on_step(i, programs)``, if
    given, sees the programs after each step, their state and wire state
    updated in place.  Raises if a loss is not finite."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_model(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    print(f"{cfg.name}: {T.param_count(params) / 1e6:.1f}M params on {dev}")
    pol = CompressionPolicy(scheme=scheme, warmup_steps=compress_warmup)
    gba = GBAConfig(local_batch=batch, buffer_size=workers,
                    staleness_tolerance=iota)
    progs = build_programs(cfg, gba, params=params, mode="wire", lr=lr,
                           workers=workers, compress=pol,
                           layer_groups=layer_groups, world=world)
    del params
    layout = progs.layout
    if world is not inprocess:
        print(f"process group: {world.backend}, {world.size} ranks x "
              f"{workers // world.size} workers")
    print(f"quantized wire ({scheme}): {workers} workers x "
          f"{layout.num_groups} groups; route "
          f"{pol.wire_bytes(layout) / 1e6:.2f}MB/worker/step vs "
          f"{layout.padded_total * 4 / 1e6:.2f}MB f32 "
          f"(ratio {pol.compression_ratio(layout):.3f}); warmup "
          f"{pol.warmup_steps} steps f32, then {pol.wire_dtype()} payload + "
          f"{pol.sideband_floats_per_tile()} f32 sideband(s)/tile; wire "
          f"state: {', '.join(pol.state_names())}")
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    param_flat, accum = progs.state["param_flat"], progs.state["accum"]
    mine, per = world.workers(workers), batch // workers
    held = slice(mine[0] * per, (mine[-1] + 1) * per)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        b = stream.batch(i)
        tensors = {k: torch.from_numpy(b[k][held]).to(dev)
                   for k in ("tokens", "labels")}
        tokens = torch.full((workers,), i, dtype=torch.int32, device=dev)
        warm = pol.stateful and i < pol.warmup_steps
        fn = progs.wire_step_for(i)
        if pol.stateful:
            *_, loss, _ = fn(param_flat, accum, tensors, tokens, i,
                             progs.wire_state)
        else:
            _, _, loss = fn(param_flat, accum, tensors, tokens, i)
        losses.append(loss.item())
        if on_step is not None:
            on_step(i, progs)
        if i % 5 == 0 or i == steps - 1 or i == pol.warmup_steps:
            phase = "warmup/f32" if warm else f"{scheme} wire"
            rate = (i + 1) * batch * seq / (time.perf_counter() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  [{phase}]  "
                  f"{rate:,.0f} tok/s")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"wire training diverged: losses {losses}")
    return losses


def on_rank(world, device: torch.device, run: Callable, cfg: ModelConfig,
            kwargs: dict) -> None:
    """One rank of ``--ranks``: ``run(cfg, **kwargs)`` (``run_wire_train``,
    ``run_lm_fused`` or ``run_autoswitch``) on ``device`` over the rank's
    ``world``."""
    run(cfg, device=device, world=world, **kwargs)


def _on_ranks(ranks: int, workers: int, device: str, run: Callable,
              cfg: ModelConfig, kwargs: dict) -> None:
    """``run`` on ``ranks`` spawned ranks of ``workers / ranks`` workers
    each, every gloo rank running this process's intra-op threads, so
    that its CPU matmuls round as they would here."""
    process_group.check_world(ranks, workers, device)
    process_group.spawn(on_rank, ranks, run, cfg, kwargs, device=device,
                        threads=torch.get_num_threads())


def run_autoswitch(cfg: ModelConfig, *, workers: int,
                   plan: str = "strained", batches: int = 120,
                   batch: int = 4, seq: int = 128, iota: int = 4,
                   lr: float = 1e-3, mode: str = "auto",
                   device: str | torch.device = "cuda",
                   params: dict | None = None, world=inprocess):
    """Run ``cfg``'s sync and async steps under the switching harness:
    ``workers`` workers, each taking local batch ``i`` of the LM stream
    (seed 0, ``batch`` sequences of ``seq`` tokens) as its slot, on the
    ``plan`` fault plan of ``switch_driver.demo_plan`` over ``batches``
    local batches, in ``mode`` (``"auto"``: the controller decides), over
    the collectives of ``world`` (all workers here by default, or this
    rank's share).  The layout is the layer-grouped one of the wire step.
    Parameters are drawn from seed 0 on the device unless ``params`` (on
    ``device``) are given.  Prints the reference launcher's summary line
    and returns the ``SwitchResult``."""
    from repro_torch.launch.switch_driver import (SwitchConfig, SwitchDriver,
                                                  demo_plan, demo_spec)
    dev = resolve_device(device)
    if params is None:
        params = T.init_model(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    print(f"{cfg.name}: {T.param_count(params) / 1e6:.1f}M params on {dev}")
    if world is not inprocess:
        print(f"process group: {world.backend}, {world.size} ranks x "
              f"{workers // world.size} workers")
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    swcfg = SwitchConfig(local_batch=batch, iota=iota, lr=lr)
    driver = SwitchDriver(workers, make_loss_fn(cfg), params,
                          spec=demo_spec(workers),
                          plan=demo_plan(plan, workers), cfg=swcfg,
                          batch_fn=stream.batch, group_by=T.param_group_key,
                          world=world)
    del params
    res = driver.run(batches, mode=mode)
    print(f"autoswitch ({plan}): {res.num_global_steps} global "
          f"steps, {res.switch_count} switch(es), mode steps "
          f"{res.mode_steps}, first switch at gstep "
          f"{res.time_to_first_switch_steps}, sim qps {res.qps:,.0f}, "
          f"crashes {res.crashes} rejoins {res.rejoins} timeouts "
          f"{res.timeouts}, swaps verified {res.swaps_verified}, "
          f"final loss {res.losses[-1] if res.losses else float('nan'):.4f}")
    if not all(math.isfinite(x) for x in res.losses):
        raise RuntimeError(f"autoswitch run diverged: losses {res.losses}")
    return res


def main(argv: list[str] | None = None):
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
                         "(forces Adagrad); default: the pytree step with "
                         "the arch's optimizer")
    ap.add_argument("--mesh", default="",
                    help="WORKERSx1 (needs --fused or --autoswitch): that "
                         "many PS shards (the sharded fused step) or, with "
                         "--compress int8|onebit, PS workers and shards "
                         "(the worker-parallel wire step), e.g. 4x1")
    ap.add_argument("--layer-groups", choices=("on", "off"), default="on",
                    help="layer-grouped flat layout of the sharded fused "
                         "and wire steps: one gather and one route per "
                         "layer group")
    ap.add_argument("--compress", choices=("none", "int8", "onebit"),
                    default="none",
                    help="quantize the wire step's gradient routing (needs "
                         "--mesh): int8 = per-tile min-max with error "
                         "feedback, onebit = sign of momentum")
    ap.add_argument("--compress-warmup", type=int, default=2,
                    help="float32 global steps before the quantized wire")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the worker-parallel step on that many "
                         "torch.distributed ranks of WORKERS / RANKS "
                         "workers or shards each: gloo on the CPU, NCCL "
                         "one rank per card (needs --mesh WORKERSx1 with "
                         "--fused or --autoswitch)")
    ap.add_argument("--autoswitch", action="store_true",
                    help="the switching harness on the arch's sync and "
                         "async steps under --plan (needs --mesh "
                         "WORKERSx1 with 2 or more workers)")
    ap.add_argument("--plan", choices=("quiet", "strained"),
                    default="strained",
                    help="fault plan of --autoswitch: quiet (a vacant "
                         "cluster) or strained (25%% stragglers at 4x and "
                         "one transient crash)")
    ap.add_argument("--batches", type=int, default=120,
                    help="local batches --autoswitch streams")
    ap.add_argument("--embed-dim", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch:
        try:
            cfg = get_config(args.arch)
        except NotImplementedError as e:
            ap.error(str(e))
        # the optimizer comes from the arch's own name, before .reduced()
        # renames the config, as in the reference
        opt_name = ARCH_OPTIMIZER.get(cfg.name, "adam")
        if args.reduced:
            cfg = cfg.reduced()
        if args.autoswitch:
            workers, _, model = args.mesh.partition("x")
            if not (workers.isdigit() and int(workers) >= 2
                    and model in ("", "1")):
                ap.error(f"--autoswitch needs --mesh WORKERSx1 with 2 or "
                         f"more workers, got --mesh {args.mesh!r}")
            kwargs = dict(workers=int(workers), plan=args.plan,
                          batches=args.batches, batch=args.batch,
                          seq=args.seq, iota=args.iota, lr=args.lr)
            if not args.ranks:
                return run_autoswitch(cfg, device=args.device, **kwargs)
            return _on_ranks(args.ranks, int(workers), args.device,
                             run_autoswitch, cfg, kwargs)
        if not args.fused:
            if args.mesh:
                ap.error("--mesh: the pytree step over PS workers is not "
                         "ported; pass --fused for the wire step")
            if args.compress != "none" or args.ranks:
                ap.error("--compress or --ranks needs --fused --mesh "
                         "WORKERSx1: the single-device step has no wire")
            return run_lm_pytree(cfg, optimizer=opt_name, steps=args.steps,
                                 batch=args.batch, seq=args.seq,
                                 buffer=args.buffer, iota=args.iota,
                                 lr=args.lr, device=args.device)
        if opt_name != "adagrad":
            print(f"--fused forces Adagrad (arch default was {opt_name})")
        if args.mesh:
            workers, _, model = args.mesh.partition("x")
            try:
                workers, model = int(workers), int(model or 1)
            except ValueError:
                ap.error(f"--mesh {args.mesh!r}: expected WORKERSx1")
            if model != 1:
                ap.error(f"--mesh {args.mesh}: a model axis above 1 is not "
                         f"ported (see ROADMAP.md)")
            if workers < 2:
                ap.error(f"--mesh {args.mesh}: needs 2 or more workers")
            if args.compress == "none":
                kwargs = dict(steps=args.steps, batch=args.batch,
                              seq=args.seq, buffer=args.buffer,
                              iota=args.iota, lr=args.lr, workers=workers,
                              layer_groups=args.layer_groups == "on")
                if not args.ranks:
                    return run_lm_fused(cfg, device=args.device, **kwargs)
                if args.batch % args.ranks:
                    ap.error(f"--ranks {args.ranks}: the sharded fused step "
                             f"splits --batch {args.batch} over the ranks")
                return _on_ranks(args.ranks, workers, args.device,
                                 run_lm_fused, cfg, kwargs)
            if args.batch % workers:
                ap.error(f"--mesh {args.mesh}: the wire step needs workers "
                         f"that divide --batch {args.batch}")
            kwargs = dict(workers=workers, scheme=args.compress,
                          steps=args.steps, batch=args.batch, seq=args.seq,
                          iota=args.iota, lr=args.lr,
                          compress_warmup=args.compress_warmup,
                          layer_groups=args.layer_groups == "on")
            if not args.ranks:
                return run_wire_train(cfg, device=args.device, **kwargs)
            return _on_ranks(args.ranks, workers, args.device,
                             run_wire_train, cfg, kwargs)
        if args.compress != "none" or args.ranks:
            ap.error("--compress or --ranks needs --mesh WORKERSx1: the "
                     "single-device step has no wire")
        return run_lm_fused(cfg,
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
