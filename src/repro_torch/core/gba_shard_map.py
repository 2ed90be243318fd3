"""The worker-parallel, layer-grouped fused PS step with the quantized
routing wire.

Counterpart of ``make_gba_fused_psum_step`` in ``repro.core.gba_shard_map``.
There every device along the mesh's ``data`` axis is one GBA worker with
its own batch shard and its own token, and also one PS shard that owns a
contiguous tile-aligned slice of the flat parameter vector
(``ShardedFlatLayout``).  Here the worker axis is written out as a loop
over the workers a process holds, and the collectives are a backend's:
``repro_torch.distributed.inprocess`` (the default: all W workers and
shards in one process on one device) or
``repro_torch.distributed.process_group`` (W / R of them on each of R
``torch.distributed`` ranks).

:func:`make_gba_psum_step` is the reference's pytree all-reduce step, the
switching harness's sync mode (``repro_torch.launch.switch_driver``):
each worker's gradient is scaled by its Eq. (1) weight over M and the
workers are summed in worker order, as ``lax.psum`` adds them, over the
same backends (``world.worker_sum``); the optimizer then updates the
replicated tree.  It launches no kernel.

Both steps take the rows of the workers held here: worker ``mine[j]``'s
chunk is the ``j``-th, as ``shard_map`` hands each device its own rows
of the global batch.  In process that is the whole batch.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.core.compression import MOMENTUM, CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout, make_sharded_apply
from repro_torch.core.gba import path_unflatten, tree_paths
from repro_torch.core.staleness import threshold_decay
from repro_torch.distributed import inprocess
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer


def _split_batch(batch: dict, m: int) -> int:
    """The rows of the batch each of ``m`` workers takes."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % m:
        raise ValueError(f"the batch's leading axes {sorted(sizes)} must "
                         f"be one size divisible by {m} workers")
    return next(iter(sizes)) // m


def _weighted_loss(losses: list, weights: torch.Tensor) -> torch.Tensor:
    """``psum(loss_w * w_w) / M``: the workers' weighted losses added in
    worker order from +0.0, as ``lax.psum`` adds the devices."""
    loss = torch.zeros((), dtype=losses[0].dtype, device=losses[0].device)
    for w, loss_w in enumerate(losses):
        loss = loss + loss_w * weights[w]
    return loss / len(losses)


def make_gba_psum_step(workers: int, loss_fn: Callable,
                       optimizer: Optimizer, iota: int,
                       world=inprocess) -> Callable:
    """``step(params, opt_state, batch, tokens, gstep) -> (params,
    opt_state, loss)``: the pytree all-reduce GBA step of ``workers`` = M
    workers over the collectives of ``world``
    (``repro_torch.distributed.inprocess``, all M in this process, or a
    ``process_group.ProcessGroupBackend``, the k workers
    ``world.workers(M)`` on each rank), ``params`` and ``opt_state``
    replicated on every rank as the reference's ``P()`` specs keep them.

    ``batch`` is a dict of tensors whose leading axis splits evenly over
    the held workers (the ``j``-th of them takes the ``j``-th chunk);
    ``tokens`` is (M,) int32, one per worker, and ``gstep`` the global
    step.  Worker after worker held here: its loss and gradient at
    ``params`` on its chunk, each leaf scaled by ``(w / M)`` cast to the
    leaf's dtype, ``w`` the Eq. (1) weight of its token; the scaled
    gradients of all M workers are added in worker order from +0.0 (Alg.
    2 l.22, ``world.worker_sum``), the loss is ``sum(loss_w * w) / M``
    over every worker's loss (``world.all_losses``), and
    ``optimizer.update`` gives the new params and state, the same bits on
    every rank.  The optimizer returns new tensors, so ``params`` and
    ``opt_state`` are left as they were and a caller may discard the
    result."""
    m = workers
    mine = world.workers(m)

    def step(params: Any, opt_state: Any, batch: dict,
             tokens: torch.Tensor, gstep: int) -> tuple[Any, Any,
                                                        torch.Tensor]:
        if tuple(tokens.shape) != (m,):
            raise ValueError(f"tokens must be ({m},), got "
                             f"{tuple(tokens.shape)}")
        b = _split_batch(batch, len(mine))
        paths, leaves = zip(*tree_paths(params))
        weights = threshold_decay(tokens, gstep, iota)
        losses = []

        def terms():
            for row, w in enumerate(mine):
                live = [x.detach().requires_grad_() for x in leaves]
                chunk = {k: v[row * b:(row + 1) * b]
                         for k, v in batch.items()}
                with torch.enable_grad():
                    loss_w = loss_fn(path_unflatten(paths, live), chunk)
                    grads = torch.autograd.grad(loss_w, live)
                del live
                losses.append(loss_w.detach())
                yield list(grads), weights[w] / m
                del grads

        agg = world.worker_sum(terms(), leaves)
        params, opt_state = optimizer.update(
            params, path_unflatten(paths, agg), opt_state)
        return params, opt_state, _weighted_loss(world.all_losses(losses),
                                                 weights)

    return step


def make_gba_fused_psum_step(workers: int, loss_fn: Callable,
                             layout: ShardedFlatLayout, *, iota: int,
                             lr: float,
                             compress: CompressionPolicy | None = None,
                             warm: bool = False,
                             world=inprocess) -> Callable:
    """The layer-grouped fused PS step of ``workers`` = M workers and M
    shards (Adagrad), with an optional quantized wire, over the
    collectives of ``world`` (``repro_torch.distributed.inprocess`` or a
    ``process_group.ProcessGroupBackend``), of which this process holds
    the k workers and shards ``world.workers(M)``.

    Without compression (``compress=None`` or scheme ``"none"``) returns
    ``step(param_flat, accum_flat, batch, tokens, gstep) -> (param_flat,
    accum_flat, loss)``.  With a lossy policy it returns ``step(param_flat,
    accum_flat, batch, tokens, gstep, wire) -> (param_flat, accum_flat,
    loss, wire)``, ``wire`` holding ``(k, padded_total)`` float32 rows
    (``residual``; ``momentum`` for onebit), row ``i`` that of the
    ``i``-th worker held here.  ``param_flat`` and ``accum_flat`` are the
    ``(k * shard_size,)`` float32 run of the layout's shard-major vector
    that the shards held here own (the whole ``(padded_total,)`` vector
    in process); ``batch`` is the held workers' rows, a dict of tensors
    whose leading axis splits evenly over the k workers (the ``j``-th of
    them takes the ``j``-th chunk, as ``shard_map`` hands each device its
    rows; in process the whole batch); ``tokens`` is (M,) int32, one per
    worker, and ``gstep`` the global step.  The reference returns new
    arrays; this step updates ``param_flat``, ``accum_flat`` and the wire
    state in place and returns them.

    Per global step, with G = ``layout.num_groups`` layer groups:

    1. gather the params (``world.all_gather``);
    2. one worker held here after another: the worker's loss and
       gradient on its batch chunk; each group's gradient is raveled into its
       ``(M, group_shard)`` block, row ``s`` bound for shard ``s``;
    3. compress (a lossy scheme past warmup): the payload is ``grad +
       residual`` (int8) or ``momentum + residual`` after the onebit EMA
       ``momentum = beta * momentum + (1 - beta) * grad``, added into the
       worker's residual row in place; one quantize launch per worker and
       group turns it into int8 codes and per-tile sidebands and leaves
       the next residual in that row;
    4. route each block worker -> shard (``world.route``): float32 in
       warmup and ``"none"``, codes and sidebands otherwise;
    5. dequantize: one launch per shard held here and group rebuilds the
       shard's
       ``(M, group_shard)`` float32 columns in one ``(M, shard_size)``
       block, reused shard after shard;
    6. apply: one ``gba_apply`` launch per shard held here on its
       contiguous slice, weighing worker ``w`` by Eq. (1) with its token;
    7. the loss: the M workers' losses (``world.all_losses``) summed, in
       worker order from +0.0 as ``psum`` adds them, each times
       ``decay(token_w)``, divided by M (computed before step 6, which it
       gates).

    ``warm=True`` builds the warmup step of a lossy policy: float32
    routing as ``"none"``, the residual untouched, the onebit momentum
    already accumulating.  The reference's EMA is one fused multiply-add
    under XLA on the CPU; here it is a product and a sum, each rounded.

    The loss is read on the host before step 6, and where it is not
    finite the apply is skipped: params and accumulator stay as they were,
    as the reference's switching harness keeps its old state after such a
    step.  The wire state has by then taken the step's update (step 3
    writes it in place)."""
    m = workers
    if layout.num_shards != m:
        raise ValueError(f"layout has {layout.num_shards} shards but there "
                         f"are {m} workers")
    mine = world.workers(m)
    k = len(mine)
    scheme = compress.scheme if compress is not None else "none"
    quantized = scheme != "none" and not warm
    mode = "minmax" if scheme == "int8" else "sign"
    sidebands = 2 if scheme == "int8" else 1
    ss, tile = layout.shard_size, layout.tile
    apply_shards = make_sharded_apply(layout, iota=iota)

    def worker_grads(leaves, batch):
        live = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(layout.unflatten(live), batch)
            grads = list(torch.autograd.grad(loss, live))
        return loss.detach(), grads

    def dequantized(codes, sides):
        """Each held shard's (M, shard_size) float32 block in turn, one
        dequantize launch per group; one block, overwritten shard after
        shard."""
        block = torch.empty((m, ss), dtype=torch.float32,
                            device=codes.device)
        for s in range(k):
            for g in range(layout.num_groups):
                lo, hi = layout.group_shard_bounds(g)
                ops.dequantize_wire(
                    codes[s][:, lo:hi],
                    *(x[s][:, lo // tile:hi // tile] for x in sides),
                    tile=tile, mode=mode, out=block[:, lo:hi])
            yield block

    def step(param_flat, accum_flat, batch, tokens, gstep, wire=None):
        if param_flat.shape != (k * ss,) or \
                accum_flat.shape != param_flat.shape:
            raise ValueError(
                f"param_flat and accum_flat must be ({k * ss},), got "
                f"{tuple(param_flat.shape)}, {tuple(accum_flat.shape)}")
        if tuple(tokens.shape) != (m,):
            raise ValueError(f"tokens must be ({m},), got "
                             f"{tuple(tokens.shape)}")
        if scheme != "none" and any(
                tuple(wire[name].shape) != (k, layout.padded_total)
                for name in compress.state_names()):
            raise ValueError(f"wire state {compress.state_names()} must be "
                             f"({k}, {layout.padded_total}) each")
        b = _split_batch(batch, k)
        dev = param_flat.device
        leaves = layout.leaves(world.all_gather(layout, param_flat))
        routed = torch.empty((k, m, ss), device=dev, dtype=(
            torch.int8 if quantized else torch.float32))
        sides = [torch.empty((k, m, ss // tile), dtype=torch.float32,
                             device=dev)
                 for _ in range(sidebands if quantized else 0)]
        losses = []
        for row, w in enumerate(mine):
            loss_w, grads = worker_grads(
                leaves, {key: v[row * b:(row + 1) * b]
                         for key, v in batch.items()})
            losses.append(loss_w)
            for g in range(layout.num_groups):
                lo, hi = layout.group_shard_bounds(g)
                gm = layout.ravel_group(g, grads).view(m, -1)
                for j in layout.group_leaves(g):
                    grads[j] = None
                if scheme == "onebit":
                    mom = wire["momentum"][row].view(m, ss)[:, lo:hi]
                    mom.mul_(MOMENTUM).add_(gm * (1.0 - MOMENTUM))
                if not quantized:
                    world.route(routed, w, lo, hi, gm)
                    continue
                payload = wire["residual"][row].view(m, ss)[:, lo:hi]
                payload.add_(mom if scheme == "onebit" else gm)
                del gm
                codes, *side = ops.quantize_wire(payload, tile=tile,
                                                 mode=mode)
                world.route(routed, w, lo, hi, codes)
                for dst, src in zip(sides, side):
                    world.route(dst, w, lo // tile, hi // tile, src)
            del grads
        del leaves
        loss = _weighted_loss(world.all_losses(losses),
                              threshold_decay(tokens, gstep, iota))
        if math.isfinite(loss.item()):
            apply_shards(param_flat, accum_flat,
                         dequantized(routed, sides) if quantized else routed,
                         tokens, gstep, lr)
        if scheme == "none":
            return param_flat, accum_flat, loss
        return param_flat, accum_flat, loss, wire

    return step
