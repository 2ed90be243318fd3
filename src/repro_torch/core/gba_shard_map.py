"""The worker-parallel, layer-grouped fused PS step with the quantized
routing wire.

Counterpart of ``make_gba_fused_psum_step`` in ``repro.core.gba_shard_map``.
There every device along the mesh's ``data`` axis is one GBA worker with
its own batch shard and its own token, and also one PS shard that owns a
contiguous tile-aligned slice of the flat parameter vector
(``ShardedFlatLayout``).  Here the W workers and W shards run in one
process on one device, the worker axis written out as a loop, and the
collectives are ``repro_torch.distributed.inprocess``'s.  The reference's
pytree sync step (``make_gba_psum_step``) is not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.compression import MOMENTUM, CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout, make_sharded_apply
from repro_torch.core.staleness import threshold_decay
from repro_torch.distributed import inprocess as world
from repro_torch.kernels import ops


def make_gba_fused_psum_step(workers: int, loss_fn: Callable,
                             layout: ShardedFlatLayout, *, iota: int,
                             lr: float,
                             compress: CompressionPolicy | None = None,
                             warm: bool = False) -> Callable:
    """The layer-grouped fused PS step of ``workers`` = M workers and M
    shards (Adagrad), with an optional quantized wire.

    Without compression (``compress=None`` or scheme ``"none"``) returns
    ``step(param_flat, accum_flat, batch, tokens, gstep) -> (param_flat,
    accum_flat, loss)``.  With a lossy policy it returns ``step(param_flat,
    accum_flat, batch, tokens, gstep, wire) -> (param_flat, accum_flat,
    loss, wire)``, ``wire`` holding ``(M, padded_total)`` float32 rows
    (``residual``; ``momentum`` for onebit), row ``w`` worker ``w``'s.
    ``param_flat`` and ``accum_flat`` are the layout's ``(padded_total,)``
    float32 vectors; ``batch`` is a dict of tensors whose leading axis
    splits evenly over the workers (worker ``w`` takes the ``w``-th chunk,
    as ``shard_map`` splits it); ``tokens`` is (M,) int32, one per worker,
    and ``gstep`` the global step.  The reference returns new arrays; this
    step updates ``param_flat``, ``accum_flat`` and the wire state in place
    and returns them.

    Per global step, with G = ``layout.num_groups`` layer groups:

    1. gather the params (``inprocess.all_gather``);
    2. one worker after another: the worker's loss and gradient on its
       batch chunk; each group's gradient is raveled into its
       ``(M, group_shard)`` block, row ``s`` bound for shard ``s``;
    3. compress (a lossy scheme past warmup): the payload is ``grad +
       residual`` (int8) or ``momentum + residual`` after the onebit EMA
       ``momentum = beta * momentum + (1 - beta) * grad``, added into the
       worker's residual row in place; one quantize launch per worker and
       group turns it into int8 codes and per-tile sidebands and leaves
       the next residual in that row;
    4. route each block worker -> shard (``inprocess.route``): float32 in
       warmup and ``"none"``, codes and sidebands otherwise;
    5. dequantize: one launch per shard and group rebuilds the shard's
       ``(M, group_shard)`` float32 columns in one ``(M, shard_size)``
       block, reused shard after shard;
    6. apply: one ``gba_apply`` launch per shard on its contiguous slice,
       weighing worker ``w`` by Eq. (1) with its token;
    7. the loss: the sum over workers, in worker order as ``psum`` adds
       them, of ``loss_w * decay(token_w)``, divided by M.

    ``warm=True`` builds the warmup step of a lossy policy: float32
    routing as ``"none"``, the residual untouched, the onebit momentum
    already accumulating.  The reference's EMA is one fused multiply-add
    under XLA on the CPU; here it is a product and a sum, each rounded."""
    m = workers
    if layout.num_shards != m:
        raise ValueError(f"layout has {layout.num_shards} shards but there "
                         f"are {m} workers")
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
        """Each shard's (M, shard_size) float32 block in turn, one
        dequantize launch per group; one block, overwritten shard after
        shard."""
        block = torch.empty((m, ss), dtype=torch.float32,
                            device=codes.device)
        for s in range(m):
            for g in range(layout.num_groups):
                lo, hi = layout.group_shard_bounds(g)
                ops.dequantize_wire(
                    codes[s][:, lo:hi],
                    *(x[s][:, lo // tile:hi // tile] for x in sides),
                    tile=tile, mode=mode, out=block[:, lo:hi])
            yield block

    def step(param_flat, accum_flat, batch, tokens, gstep, wire=None):
        if param_flat.shape != (layout.padded_total,) or \
                accum_flat.shape != param_flat.shape:
            raise ValueError(
                f"param_flat and accum_flat must be ({layout.padded_total},)"
                f", got {tuple(param_flat.shape)}, {tuple(accum_flat.shape)}")
        if tuple(tokens.shape) != (m,):
            raise ValueError(f"tokens must be ({m},), got "
                             f"{tuple(tokens.shape)}")
        if scheme != "none" and any(
                tuple(wire[k].shape) != (m, layout.padded_total)
                for k in compress.state_names()):
            raise ValueError(f"wire state {compress.state_names()} must be "
                             f"({m}, {layout.padded_total}) each")
        sizes = {v.shape[0] for v in batch.values()}
        if len(sizes) != 1 or next(iter(sizes)) % m:
            raise ValueError(f"the batch's leading axes {sorted(sizes)} must "
                             f"be one size divisible by {m} workers")
        b = next(iter(sizes)) // m
        dev = param_flat.device
        leaves = layout.leaves(world.all_gather(layout, param_flat))
        routed = torch.empty((m, m, ss), device=dev, dtype=(
            torch.int8 if quantized else torch.float32))
        sides = [torch.empty((m, m, ss // tile), dtype=torch.float32,
                             device=dev)
                 for _ in range(sidebands if quantized else 0)]
        losses = []
        for w in range(m):
            loss_w, grads = worker_grads(
                leaves, {k: v[w * b:(w + 1) * b] for k, v in batch.items()})
            losses.append(loss_w)
            for g in range(layout.num_groups):
                lo, hi = layout.group_shard_bounds(g)
                gm = layout.ravel_group(g, grads).view(m, -1)
                for j in layout.group_leaves(g):
                    grads[j] = None
                if scheme == "onebit":
                    mom = wire["momentum"][w].view(m, ss)[:, lo:hi]
                    mom.mul_(MOMENTUM).add_(gm * (1.0 - MOMENTUM))
                if not quantized:
                    world.route(routed, w, lo, hi, gm)
                    continue
                payload = wire["residual"][w].view(m, ss)[:, lo:hi]
                payload.add_(mom if scheme == "onebit" else gm)
                del gm
                codes, *side = ops.quantize_wire(payload, tile=tile,
                                                 mode=mode)
                world.route(routed, w, lo, hi, codes)
                for dst, src in zip(sides, side):
                    world.route(dst, w, lo // tile, hi // tile, src)
            del grads
        del leaves
        apply_shards(param_flat, accum_flat,
                     dequantized(routed, sides) if quantized else routed,
                     tokens, gstep, lr)
        weights = threshold_decay(tokens, gstep, iota)
        loss = losses[0] * weights[0]
        for w in range(1, m):
            loss = loss + losses[w] * weights[w]
        loss = loss / m
        if scheme == "none":
            return param_flat, accum_flat, loss
        return param_flat, accum_flat, loss, wire

    return step
