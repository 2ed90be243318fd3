"""Training launcher of the port: the LM's pytree GBA step, its fused
flat-buffer step, its worker-parallel wire step, and the sparse-module
smoke.

    python -m repro_torch.launch.train --arch granite-8b [--fused] \\
        [--reduced] [--steps 20] [--batch 4] [--seq 128] [--buffer 4] \\
        [--iota 4] [--lr 1e-3] [--device cuda]
    python -m repro_torch.launch.train --arch granite-8b --fused \\
        --mesh 4x1 [--compress {none,int8,onebit}] [--compress-warmup 2] \\
        [--layer-groups {on,off}] [--ranks R] [--reduced] [--steps 20] ...
    python -m repro_torch.launch.train --arch granite-8b --fused \\
        --mesh WxT [--ranks R] [--reduced] [--steps 20] ...
    python -m repro_torch.launch.train --arch granite-8b --mesh WxT \\
        --autoswitch [--plan {quiet,strained}] [--batches 120] [--ranks R] \\
        [--reduced]
    python -m repro_torch.launch.train --vocab 1000000 --steps 5 \\
        [--embed-dim 16] [--batch 4] [--lr 1e-3] [--device cuda]

``--arch`` trains the LM with the pytree GBA step, the reference
launcher's default (``repro_torch.launch.programs``, ``mode="pytree"``):
per microstep the LM loss and its gradient, added into a per-leaf
accumulator with its Eq. (1) weight over M, and on every M-th microstep
the arch's optimizer (``ARCH_OPTIMIZER``: Adagrad for kimi-k2, Adam for
the others) applies
it.  With ``--fused`` it trains with the fused flat-buffer step instead:
per microstep the gradient into the (M, N) buffer, and on every M-th
microstep one ``gba_apply`` launch (Eq. (1) weights and Adagrad) over the
flat params; ``--fused`` forces Adagrad, as in the reference.  Microstep
``i`` carries the token ``i // M``, as in ``repro.launch.train``.
``--reduced`` takes the config's smoke variant.  ``--arch`` trains all
ten architectures: the attention-family ones (granite-8b, gemma2-27b,
gemma3-12b, starcoder2-3b, phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b), the
Mamba2 ones (mamba2-780m, zamba2-2.7b) and the two with cross layers over
a memory (llama-3.2-vision-11b, seamless-m4t-medium); kimi-k2's optimizer
is Adagrad, the others' Adam.  The batches of a model with cross layers
carry the reference launcher's memory (``lm_batch``): zeros of ``(batch,
num_image_tokens, d_model)`` as ``image_embeds`` for the VLM, or of
``(batch, encoder_frames, d_model)`` as ``frames``, which the audio
encoder runs through inside the loss, in the model dtype.  Unlike the
reference's launcher, ``--reduced`` does not switch an Adagrad
architecture to the fused step: ``--fused`` asks for it.

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
(the ranks then share the cores R times over).

``--fused --mesh WxT`` with T > 1 (``--compress none``) runs the sharded
fused step over a (data W, model T) mesh (``run_lm_fused`` with ``model``
T): the model's attention heads, MLP columns, experts and vocabulary
split over T model shards by the reference's rule tables
(``repro_torch.distributed.sharding``, ``distributed.tensor_parallel``),
each model shard's flat state split into W data shards, and W * T
``gba_apply`` launches an apply.  ``--ranks R`` puts it on an (R / Rm,
Rm) grid of ranks, Rm the largest divisor of T that divides R with R /
Rm dividing W (``process_group.grid``): the ranks of one data coordinate
take the same batch rows and hold T / Rm model shards each.  Every arch
runs at every T the rules split (the Mamba2 mixer, gathered whole; the
rules' head_dim fallback).

At every T with W > 1 the sharded fused step holds each weight's rows
over ``data`` as the reference's ``device_put`` of ``param_specs`` places
them (FSDP, ``repro_torch.distributed.fsdp``): a process keeps the blocks
of its (data, model) shards alone, gathers each module over ``data`` on
use (``blocks`` a repeat at a time) and reduces its gradient over the
data ranks in float32; the launcher prints the bytes it holds, the
rules' share, the whole tree's, and the largest gather.

Where the reference leaves ``model`` unused, so does the port, and says
that the model axis of T is replicated: ``--fused --mesh WxT --compress
int8|onebit`` runs the wire step over W workers, ``--autoswitch --mesh
WxT`` the switching harness over W workers, ``--mesh WxT`` without
``--fused`` the pytree step as without ``--mesh``, and ``--fused --mesh
1xT`` the single-layout fused step (a data axis of 1, where
``--compress`` falls back to none).

``--mesh WxT --autoswitch`` runs the switching harness
(``repro_torch.launch.switch_driver``) on the arch's steps
(``run_autoswitch``): the pytree sync step with Adagrad and the
token-controlled worker-parallel async step, W workers with ``--batch``
sequences each, under the ``--plan`` fault plan, switching on live
telemetry over ``--batches`` local batches.  It needs no ``--fused`` and 2
or more workers; ``--ranks R`` runs it on R ranks of W / R workers each.
Its batches are the stream's tokens and labels alone, as the reference's
``batch_fn`` gives them: a cross layer's ``xattn`` then runs without a
memory, as a second causal self-attention, and the audio encoder takes
no gradient.
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
from repro_torch.distributed import fsdp, inprocess, process_group
from repro_torch.distributed import sharding as S
from repro_torch.embeddings.table import (EmbeddingTable, hash_ids,
                                          init_table, pooled_lookup)
from repro_torch.kernels.embedding_bag import (bwd_launch_meta,
                                               fwd_launch_meta)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.distributed.tensor_parallel import model_axis
from repro_torch.launch.mesh import parse_mesh
from repro_torch.launch.programs import (ARCH_OPTIMIZER, TrainPrograms,
                                         build_programs, make_loss_fn)
from repro_torch.models import layers as L
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
    fwd = fwd_launch_meta(batch, NUM_FIELDS, vocab, embed_dim)
    bwd = bwd_launch_meta(batch, NUM_FIELDS, vocab, embed_dim)
    log(f"embedding smoke: V={vocab:,} D={embed_dim} "
        f"table={vocab * embed_dim * 4 / 1e6:.0f}MB on {dev}; kernel shared "
        f"memory fwd={fwd.smem_bytes():,}B bwd={bwd.smem_bytes():,}B a block "
        f"(V-independent)")
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


def lm_batch(cfg: ModelConfig, b: dict, device: torch.device,
             rows: slice = slice(None)) -> dict:
    """A microstep's batch on ``device`` from the stream's batch ``b``: its
    ``tokens`` and ``labels`` at ``rows``, and for a model with cross
    layers the reference launcher's memory of those rows, zeros in the
    model dtype: ``image_embeds`` (rows, num_image_tokens, d_model) for a
    VLM, ``frames`` (rows, encoder_frames, d_model) for an audio model."""
    batch = {k: torch.from_numpy(b[k][rows]).to(device)
             for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        key, length = (("image_embeds", cfg.num_image_tokens)
                       if cfg.family == "vlm" else
                       ("frames", cfg.encoder_frames))
        batch[key] = torch.zeros(
            (batch["tokens"].shape[0], length, cfg.d_model),
            dtype=L.dtype_of(cfg), device=device)
    return batch


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
        tensors = lm_batch(cfg, stream.batch(i), dev)
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
                 layer_groups: bool = True, model: int = 1,
                 device: str | torch.device = "cuda",
                 world=inprocess) -> list[float]:
    """Train ``cfg`` for ``steps`` microsteps of the fused GBA step on the
    LM stream (seed 0), its flat state split into ``workers`` PS shards
    when there are 2 or more (layer-grouped unless ``layer_groups`` is
    False), the model split over ``model`` model shards when that is above
    1, the shards and each microstep's ``batch`` sequences spread over the
    ranks of ``world`` (all here by default); returns the losses.
    Parameters are drawn from seed 0 on the device.  Raises if a loss is
    not finite."""
    dev = resolve_device(device)
    if batch % world.size:
        raise ValueError(f"{world.size} ranks must divide --batch {batch}")
    params = T.init_model(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
    gba = GBAConfig(local_batch=batch, buffer_size=buffer,
                    staleness_tolerance=iota)
    count = T.param_count(params)
    progs = build_programs(cfg, gba, params=params, mode="fused", lr=lr,
                           workers=workers, layer_groups=layer_groups,
                           world=world, model=model)
    del params
    stream = make_lm_stream(cfg.vocab_size, seq, batch, seed=0)
    print(f"{cfg.name}: {count / 1e6:.1f}M params on {dev}")
    rows, mine = batch // world.size, world.workers(max(workers, 1))
    if world is not inprocess:
        print(f"process group: {world.backend}, {world.size} ranks x "
              f"{len(mine)} shards, {rows} sequences a rank a microstep"
              + (f"; {world.model_size} model ranks" if model > 1 else ""))
    first = mine[0] // len(mine) * rows
    layout = progs.layout
    if progs.model_axis is not None:
        tp = progs.model_axis
        print(f"model axis: mesh data={workers} x model={model}, model "
              f"shards {list(tp.held)} held here, split "
              f"{sorted(tp.split)}; per model shard N={layout.total:,} "
              f"over {workers} data shard(s) of {layout.shard_size:,}; "
              f"{workers * model} gba_apply launches an apply")
    elif isinstance(layout, ShardedFlatLayout):
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
    if progs.placement is not None:
        pl = progs.placement
        shapes = T.param_shapes(cfg)
        whole = sum(x.numel() * x.element_size()
                    for x in T._leaves(shapes))
        share = S.block_bytes(shapes, pl.specs, pl.mesh)
        held = fsdp.held_bytes(progs.state["params"])
        n = len(progs.state["params"]) * len(pl.held)
        name, gathered = fsdp.largest_gather(pl)
        print(f"fsdp: weights held over data={workers}: this process "
              f"holds {held:,} B in {n} block{'s' * (n > 1)}, the rules' "
              f"share "
              f"({share:,} B a block) of the whole tree's {whole:,} B; "
              f"largest gather {name} {gathered:,} B a model shard; "
              f"re-layout transient at most "
              f"{fsdp.transient_bytes(pl):,} B float32 (windows of "
              f"{fsdp.WINDOW:,} elements; peak_gather, the largest layer "
              f"group, {layout.peak_gather_bytes:,} B)")
    state, losses = progs.state, []
    t0 = time.perf_counter()
    for i in range(steps):
        tensors = lm_batch(cfg, stream.batch(i), dev,
                           slice(first, first + rows))
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
        tensors = lm_batch(cfg, stream.batch(i), dev, held)
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
              cfg: ModelConfig, kwargs: dict, model: int = 1) -> None:
    """``run`` on ``ranks`` spawned ranks, an (R / Rm, Rm) grid over the
    (``workers``, ``model``) mesh (``process_group.grid``), every gloo
    rank running this process's intra-op threads, so that its CPU
    matmuls round as they would here."""
    rm = process_group.grid(ranks, workers, model)
    process_group.check_world(ranks, workers, device, rm, model)
    process_group.spawn(on_rank, ranks, run, cfg, kwargs, device=device,
                        threads=torch.get_num_threads(), model_ranks=rm)


def _replicated(model: int, step: str) -> None:
    """Say that ``step`` runs with the model axis of ``model`` replicated
    (where it is above 1): the reference's step leaves ``model``
    unused."""
    if model > 1:
        print(f"model axis of {model} replicated: {step} over the data axis "
              f"alone, as in the reference")


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
    The batches hold no memory, as the reference's ``batch_fn``'s: the
    cross layers' ``xattn`` runs as a second causal self-attention.
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
                    help="LM architecture (all ten are ported)")
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
                    help="WORKERSxMODEL: with --fused, that many PS shards "
                         "(the sharded fused step) over MODEL "
                         "tensor-parallel model shards, e.g. 2x2 (1xMODEL: "
                         "the single-layout step); with --compress "
                         "int8|onebit or --autoswitch, WORKERS PS workers "
                         "and shards, the model replicated; without "
                         "either, the pytree step, unplaced")
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
                         "one rank per card (needs --mesh WORKERSxMODEL "
                         "with 2 or more workers and --fused or "
                         "--autoswitch); with --fused and MODEL > 1 an "
                         "(R / Rm, Rm) grid of data and model ranks")
    ap.add_argument("--autoswitch", action="store_true",
                    help="the switching harness on the arch's sync and "
                         "async steps under --plan (needs --mesh "
                         "WORKERSxMODEL with 2 or more workers; the model "
                         "axis is replicated)")
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
            T.check_supported(cfg)
        except NotImplementedError as e:
            ap.error(str(e))
        # the optimizer comes from the arch's own name, before .reduced()
        # renames the config, as in the reference
        opt_name = ARCH_OPTIMIZER.get(cfg.name, "adam")
        if args.reduced:
            cfg = cfg.reduced()
        mesh = None
        if args.mesh:
            try:
                mesh = parse_mesh(args.mesh)
            except ValueError as e:
                ap.error(str(e))
        workers, model = ((mesh.shape["data"], mesh.shape["model"]) if mesh
                          else (1, 1))
        if args.autoswitch:
            if workers < 2:
                ap.error(f"--autoswitch needs --mesh WORKERSxMODEL with 2 "
                         f"or more workers, got --mesh {args.mesh!r}")
            _replicated(model, "the switching harness runs its steps")
            kwargs = dict(workers=workers, plan=args.plan,
                          batches=args.batches, batch=args.batch,
                          seq=args.seq, iota=args.iota, lr=args.lr)
            if not args.ranks:
                return run_autoswitch(cfg, device=args.device, **kwargs)
            return _on_ranks(args.ranks, workers, args.device,
                             run_autoswitch, cfg, kwargs)
        if not args.fused:
            if args.compress != "none" or args.ranks:
                ap.error("--compress or --ranks needs --fused --mesh "
                         "WORKERSxMODEL: the single-device step has no wire")
            if mesh:
                print(f"mesh data={workers} x model={model}: the pytree step "
                      f"runs unplaced, as without --mesh; the model axis of "
                      f"{model} is replicated, as in the reference's "
                      f"launcher (the placed pytree step is "
                      f"launch.steps.build_step's train step)")
            return run_lm_pytree(cfg, optimizer=opt_name, steps=args.steps,
                                 batch=args.batch, seq=args.seq,
                                 buffer=args.buffer, iota=args.iota,
                                 lr=args.lr, device=args.device)
        if opt_name != "adagrad":
            print(f"--fused forces Adagrad (arch default was {opt_name})")
        if workers > 1 and args.compress != "none":
            if args.batch % workers:
                ap.error(f"--mesh {args.mesh}: the wire step needs workers "
                         f"that divide --batch {args.batch}")
            _replicated(model, "the wire step runs")
            kwargs = dict(workers=workers, scheme=args.compress,
                          steps=args.steps, batch=args.batch, seq=args.seq,
                          iota=args.iota, lr=args.lr,
                          compress_warmup=args.compress_warmup,
                          layer_groups=args.layer_groups == "on")
            if not args.ranks:
                return run_wire_train(cfg, device=args.device, **kwargs)
            return _on_ranks(args.ranks, workers, args.device,
                             run_wire_train, cfg, kwargs)
        if workers > 1:
            kwargs = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                          buffer=args.buffer, iota=args.iota, lr=args.lr,
                          workers=workers,
                          layer_groups=args.layer_groups == "on",
                          model=model)
            try:
                if model > 1:
                    model_axis(cfg, mesh, inprocess)
                if not args.ranks:
                    return run_lm_fused(cfg, device=args.device, **kwargs)
                rm = process_group.grid(args.ranks, workers, model)
            except ValueError as e:
                ap.error(str(e))
            if args.batch % (args.ranks // rm):
                ap.error(f"--ranks {args.ranks}: the sharded fused step "
                         f"splits --batch {args.batch} over "
                         f"{args.ranks // rm} data ranks")
            return _on_ranks(args.ranks, workers, args.device,
                             run_lm_fused, cfg, kwargs, model)
        if args.compress != "none" or args.ranks:
            ap.error("--compress or --ranks needs --mesh WORKERSxMODEL with "
                     "2 or more workers: the single-device step has no wire")
        if mesh:
            print(f"mesh data=1 x model={model}: the single-layout fused "
                  f"step, as without --mesh; the model axis of {model} is "
                  f"replicated")
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
