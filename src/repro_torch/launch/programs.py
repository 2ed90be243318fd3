"""The LM's GBA training programs: ``build_programs``.

Counterpart of ``repro.launch.programs`` for its four modes.

``pytree``
    One device, any optimizer: the reference launcher's default LM path
    (granite-8b trains with Adam, ``ARCH_OPTIMIZER``).  Each microstep
    adds ``g * (w / M)`` to a per-leaf accumulator in the accumulator's
    dtype, ``w`` the Eq. (1) weight of the microstep's token against the
    current global step; on every M-th microstep ``optimizer.update``
    applies the accumulator, which is then zeroed, and ``gstep`` advances.
``fused``
    One device.  The model's params stay a tree (the forward consumes
    them); the Adagrad accumulator and the M-slot gradient buffer live
    flat (``repro_torch.core.gba``).  Each microstep computes the LM loss
    and its gradient and ravels the gradient into the buffer; on every
    M-th microstep ONE ``gba_apply`` launch aggregates the buffer with the
    token-control weights of Eq. (1) and applies Adagrad to the whole flat
    vector.  With ``workers`` W > 1 the flat vectors are W PS shards'
    slices (``repro_torch.core.flat_sharded``, layer-grouped by default)
    and the apply is one ``gba_apply`` launch per shard, W per global
    step: the reference's sharded fused step, its microsteps on the one
    device or, over ``torch.distributed`` ranks (``world``), each
    microstep's batch split over R ranks that hold W / R shards each.
``wire``
    W PS workers, each also a shard (``repro_torch.core.gba_shard_map``),
    in one process on one device or spread over ``torch.distributed``
    ranks (``world``): per global step every worker
    takes the gradient of its own slice of the batch, routes it per layer
    group to the shards, optionally over the quantized wire
    (``repro_torch.core.compression``), and each shard applies with one
    ``gba_apply`` launch.  ``(warm_step, compressed_step)`` are two step
    functions, switched by the launcher at ``compress.warmup_steps``.
``sync_psum``
    W workers in one process on one device, or over ranks
    (``core.gba_shard_map.make_gba_psum_step``): per global step every
    worker's gradient of its own slice of the batch, scaled by its Eq. (1)
    weight over W, summed over the workers in order, then Adagrad (PyTorch
    operators, as in the reference) on the replicated tree.  The switching
    harness's sync mode.

PyTorch runs eagerly, so there is nothing to jit: a "program"
is the step function, and it updates its state in place where the
reference donates it (the sync_psum step returns new tensors, as its
optimizer does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import GBAConfig, ModelConfig
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import (TILE, ShardedFlatLayout,
                                           init_sharded_flat_buffer,
                                           make_sharded_apply,
                                           sharded_flat_push)
from repro_torch.core.gba import (FlatLayout, flat_buffer_push,
                                  init_flat_buffer, path_unflatten,
                                  tree_paths)
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.core.staleness import threshold_decay
from repro_torch.distributed import inprocess
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adagrad, get_optimizer, tree_map

# the paper's GBA mode runs Adam (Tab. 5.1, "Others"); the 1T MoE cannot hold
# Adam's two f32 moments at 512 chips, so it trains with Adagrad, the
# optimizer the paper uses for its async mode, with a bfloat16 accumulator
ARCH_OPTIMIZER = {"kimi-k2-1t-a32b": "adagrad"}
ARCH_ACC_DTYPE = {"kimi-k2-1t-a32b": torch.bfloat16}


def _loss_from_batch(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return T.lm_loss(params, cfg, batch["tokens"], batch["labels"])


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss_fn(params, batch) -> scalar``, the LM loss of ``cfg``: the
    signature of the worker-parallel steps and the switching harness."""
    def loss_fn(params, batch):
        return _loss_from_batch(params, cfg, batch)
    return loss_fn


def loss_and_grads(cfg: ModelConfig, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """The LM loss at ``params`` (detached) and its gradient tree, each
    leaf in its param's dtype, with autograd; ``params`` are left as they
    were."""
    return _grads_of(make_loss_fn(cfg), params, batch)


def _grads_of(loss_fn: Callable, params: Any, batch: dict
              ) -> tuple[torch.Tensor, Any]:
    """``loss_fn(params, batch)`` (detached) and its gradient tree."""
    paths, leaves = zip(*tree_paths(params))
    live = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(path_unflatten(paths, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), path_unflatten(paths, list(grads))


# Adagrad's initial accumulator (the reference's default; no ported caller
# sets another)
INITIAL_ACCUM = 0.1


def init_train_state(params: Any, optimizer: Optimizer,
                     acc_dtype: torch.dtype = torch.float32) -> dict:
    """State of the pytree step on the params' device: ``params``, the
    optimizer's state ``opt``, the accumulator ``acc`` (zeros of each
    leaf's shape in ``acc_dtype``), and the host integers ``micro`` and
    ``gstep``."""
    return {
        "params": params,
        "opt": optimizer.init(params),
        "acc": tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                              device=p.device), params),
        "micro": 0,
        "gstep": 0,
    }


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    gba: GBAConfig) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)``: the LM loss and
    its gradient; ``acc += g.to(acc.dtype) * (w / M)``, in place, with
    ``w`` the threshold weight of ``token`` against ``gstep`` and ``w / M``
    rounded to the accumulator's dtype, as the reference computes it; on
    every M-th microstep ``optimizer.update(params, acc, opt)`` gives new
    params and optimizer state, the accumulator is zeroed in place and
    ``gstep`` advances.  On the other microsteps ``params`` and ``opt``
    come back as the very objects that went in.  ``batch`` holds
    ``tokens`` and ``labels`` (B, S) on the params' device."""
    m = gba.buffer_size
    iota = gba.staleness_tolerance

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        params = state["params"]
        loss, grads = loss_and_grads(cfg, params, batch)
        w = threshold_decay(torch.tensor([token], dtype=torch.int32),
                            state["gstep"], iota)[0]
        tree_map(lambda a, g: a.add_(g.to(a.dtype)
                                     * float((w / m).to(a.dtype))),
                 state["acc"], grads)
        del grads
        micro = state["micro"] + 1
        is_full = micro % m == 0
        opt = state["opt"]
        if is_full:
            params, opt = optimizer.update(params, state["acc"], opt)
            tree_map(lambda a: a.zero_(), state["acc"])
        return {"params": params, "opt": opt, "acc": state["acc"],
                "micro": micro,
                "gstep": state["gstep"] + int(is_full)}, loss

    return train_step


def init_fused_train_state(params: Any, gba: GBAConfig, workers: int = 1,
                           layer_groups: bool = True, tile: int = TILE,
                           world=inprocess
                           ) -> tuple[FlatLayout | ShardedFlatLayout, dict]:
    """State of the fused step on the params' device: ``params`` (the
    tree), ``accum`` filled with ``INITIAL_ACCUM``, and the flat
    ``buffer``.  One worker: the ``FlatLayout``, ``accum`` (N,) float32.
    ``workers`` W > 1: the ``ShardedFlatLayout`` of W shards over
    ``tile``, layer-grouped by ``models.transformer.param_group_key``
    unless ``layer_groups`` is False, and the shards ``world`` holds here
    (all W in process, W / R on each of R ranks): ``accum`` their
    ``(k * shard_size,)`` run and the buffer of their k blocks
    (``init_sharded_flat_buffer``).  Returns (layout, state)."""
    if workers > 1:
        layout, buffer = init_sharded_flat_buffer(
            params, gba.buffer_size, workers, tile,
            group_by=T.param_group_key if layer_groups else None,
            held=len(world.workers(workers)))
        total = buffer["grads"].shape[1] * layout.shard_size
    else:
        layout, buffer = init_flat_buffer(params, gba.buffer_size)
        total = layout.total
    accum = torch.full((total,), INITIAL_ACCUM, dtype=torch.float32,
                       device=buffer["grads"].device)
    return layout, {"params": params, "accum": accum, "buffer": buffer}


def make_fused_train_step(cfg: ModelConfig, gba: GBAConfig,
                          layout: FlatLayout | ShardedFlatLayout,
                          lr: float = 1e-3, world=inprocess,
                          loss_fn: Callable | None = None) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)``: push the
    raveled gradient; when the push fills the buffer, ONE ``gba_apply``
    launch (a ``FlatLayout``), or one per shard held here (a
    ``ShardedFlatLayout``, each on its contiguous ``(M, shard_size)``
    block), weighs each slot against the step *before* the push and
    updates the flat params and the accumulator.  The params are raveled
    and unraveled only on that microstep; on the others ``params`` and
    ``accum`` come back as the very tensors that went in.  ``batch`` holds
    ``tokens`` and ``labels`` (B, S) on the params' device; ``loss_fn``
    replaces the LM loss of ``cfg``.

    Over R > 1 ranks (``world`` a ``process_group.ProcessGroupBackend``
    and a sharded layout) ``batch`` is this rank's rows, an R-th of the
    microstep's, and the rank holds its k = W / R shards' run of
    ``accum`` and buffer: its loss is its rows' share of the whole
    batch's mean (its own mean over R), whose gradient, raveled
    shard-major, is reduce-scattered into the shards' columns
    (``world.reduce_scatter``) and pushed; the apply updates the rank's
    run of the params, which are then gathered tiled
    (``world.all_gather``) for the next forward.  The loss returned is the
    sum of the ranks' shares in rank order, the same on every rank.  With
    one process this is the step above, bit for bit."""
    iota = gba.staleness_tolerance
    loss_fn = loss_fn or make_loss_fn(cfg)
    ranks = world.size
    if isinstance(layout, ShardedFlatLayout):
        apply_shards = make_sharded_apply(layout, iota=iota)
        mine = world.workers(layout.num_shards)
        ss = layout.shard_size
        lo, hi = mine[0] * ss, (mine[-1] + 1) * ss

        def push(buffer, flat_grad, token):
            return sharded_flat_push(layout, buffer,
                                     world.reduce_scatter(flat_grad), token)

        def apply(params, accum, buffer, step):
            flat_p = layout.ravel(params)[lo:hi]
            apply_shards(flat_p, accum, buffer["grads"].unbind(1),
                         buffer["tokens"], step, lr)
            return world.all_gather(layout, flat_p)
    else:
        if ranks > 1:
            raise ValueError(f"the single-FlatLayout step does not split "
                             f"over {ranks} ranks")
        push = flat_buffer_push

        def apply(params, accum, buffer, step):
            flat_p = layout.ravel(params)
            ops.gba_apply_flat(flat_p, accum, buffer["grads"],
                               buffer["tokens"], step, lr, iota=iota)
            return layout.unravel(flat_p)

    share = loss_fn if ranks == 1 else (
        lambda params, batch: loss_fn(params, batch) / ranks)

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        params, accum, buffer = state["params"], state["accum"], \
            state["buffer"]
        loss, grads = _grads_of(share, params, batch)
        new_buffer, is_full = push(buffer, layout.ravel(grads), token)
        del grads
        if is_full:
            params = apply(params, accum, new_buffer, buffer["step"])
        if ranks > 1:
            total = torch.zeros((), dtype=loss.dtype, device=loss.device)
            for part in world.all_losses([loss]):
                total = total + part
            loss = total
        return {"params": params, "accum": accum,
                "buffer": new_buffer}, loss

    return train_step


def make_wire_psum_steps(cfg: ModelConfig, gba: GBAConfig,
                         layout: ShardedFlatLayout, workers: int, *,
                         compress: CompressionPolicy | None = None,
                         lr: float = 1e-3, world=inprocess
                         ) -> tuple[Callable, Callable]:
    """``(warm_step, compressed_step)`` of the worker-parallel
    layer-grouped step (``core.gba_shard_map``) on the LM loss over the
    collectives of ``world``: with a lossy policy, the float32 warmup step
    and the quantized one; with ``compress=None`` or scheme ``"none"``,
    one uncompressed step twice."""
    def build(warm: bool) -> Callable:
        return make_gba_fused_psum_step(
            workers, make_loss_fn(cfg), layout,
            iota=gba.staleness_tolerance, lr=lr, compress=compress,
            warm=warm, world=world)

    if compress is None or not compress.stateful:
        step = build(False)
        return step, step
    return build(True), build(False)


def init_wire_state(layout: ShardedFlatLayout,
                    compress: CompressionPolicy | None, workers: int,
                    device: torch.device) -> dict | None:
    """Zero per-worker wire state (residual, and momentum for onebit) on
    ``device``: ``(workers, padded_total)`` float32 each; ``None`` for a
    lossless policy."""
    if compress is None or not compress.stateful:
        return None
    return compress.init_wire_state(layout, workers, device)


@dataclass
class TrainPrograms:
    """What a launcher needs to run one mode: the state, the step(s) and,
    for the flat modes, the layout.  ``pytree`` fills ``state``
    (``params``, ``opt``, ``acc``, ``micro``, ``gstep``), ``step`` and
    ``optimizer``; ``fused`` fills ``layout``, ``state`` (``params``,
    ``accum``, ``buffer``) and ``step``; ``wire`` fills ``layout``,
    ``state`` (``param_flat``, ``accum``), ``warm_step``,
    ``compressed_step``, ``wire_state`` and ``compress``; ``sync_psum``
    fills ``state`` (``params``, ``opt``), ``step`` and ``optimizer``."""

    layout: Any
    state: dict
    step: Callable | None = None
    optimizer: Optimizer | None = None
    warm_step: Callable | None = None
    compressed_step: Callable | None = None
    wire_state: dict | None = None
    compress: CompressionPolicy | None = None

    def wire_step_for(self, async_steps_taken: int) -> Callable:
        """The wire step for a global step after ``async_steps_taken``
        async global steps: the warmup step until
        ``compress.warmup_steps``, the compressed step after (one step for
        a lossless policy)."""
        if self.compress is None or not self.compress.stateful:
            return self.warm_step
        return (self.warm_step
                if async_steps_taken < self.compress.warmup_steps
                else self.compressed_step)


def build_programs(cfg: ModelConfig, gba: GBAConfig, *, params: Any,
                   mode: str = "fused", lr: float = 1e-3,
                   optimizer: Optimizer | None = None,
                   acc_dtype: torch.dtype | None = None,
                   workers: int = 1,
                   compress: CompressionPolicy | None = None,
                   layer_groups: bool = True,
                   world=inprocess) -> TrainPrograms:
    """The step(s) of ``mode`` and their state, from ``params`` (on the
    device the steps run on).

    ``pytree`` takes ``optimizer`` or, by default, the arch's
    (``ARCH_OPTIMIZER``, else Adam at ``lr``), and an accumulator in
    ``acc_dtype`` or the arch's (``ARCH_ACC_DTYPE``, else float32).

    ``fused`` with ``workers`` > 1 splits the flat vectors into that many
    PS shards, layer-grouped unless ``layer_groups`` is False
    (``init_fused_train_state``), of which this process holds
    ``world.workers(workers)``: all of them in process, W / R on each of
    R ranks, whose steps take their R-th of each microstep's batch.

    ``wire`` runs ``workers`` PS workers and shards over the collectives
    of ``world`` (``distributed.inprocess``, or a
    ``distributed.process_group.ProcessGroupBackend``): the layout is a
    ``ShardedFlatLayout`` over ``TILE``, layer-grouped by
    ``models.transformer.param_group_key`` unless ``layer_groups`` is
    False; ``param_flat`` is the run of the raveled params that the
    shards held here own (all of it in process), ``accum`` is filled
    with ``INITIAL_ACCUM``, and the wire state has a row per worker held
    here.

    ``sync_psum`` runs ``workers`` workers over the collectives of
    ``world``, the params and the optimizer state replicated, with
    ``optimizer`` or, by default, Adagrad at ``lr`` with
    ``INITIAL_ACCUM``, as the reference's
    ``build_programs(mode="sync_psum")``.

    The worker-parallel steps (``wire``, ``sync_psum``) take the rows of
    the workers held here (the whole batch in process)."""
    T.check_supported(cfg)
    if mode == "pytree":
        opt = optimizer or get_optimizer(
            ARCH_OPTIMIZER.get(cfg.name, "adam"), lr)
        dt = acc_dtype or ARCH_ACC_DTYPE.get(cfg.name, torch.float32)
        return TrainPrograms(layout=None,
                             state=init_train_state(params, opt, dt),
                             step=make_train_step(cfg, opt, gba),
                             optimizer=opt)
    if mode == "fused":
        if workers < 1:
            raise ValueError(f"fused mode needs 1 or more workers, got "
                             f"{workers}")
        layout, state = init_fused_train_state(params, gba, workers,
                                               layer_groups, world=world)
        return TrainPrograms(layout=layout, state=state,
                             step=make_fused_train_step(cfg, gba, layout,
                                                        lr=lr, world=world))
    if mode == "wire":
        if workers < 2:
            raise ValueError(f"wire mode needs 2 or more workers, got "
                             f"{workers}")
        layout = ShardedFlatLayout.from_params(
            params, workers, TILE,
            group_by=T.param_group_key if layer_groups else None)
        mine = world.workers(workers)
        param_flat = layout.ravel(params)
        if len(mine) < workers:
            ss = layout.shard_size
            param_flat = param_flat[mine[0] * ss:(mine[-1] + 1) * ss].clone()
        state = {"param_flat": param_flat,
                 "accum": torch.full_like(param_flat, INITIAL_ACCUM)}
        warm, comp = make_wire_psum_steps(cfg, gba, layout, workers,
                                          compress=compress, lr=lr,
                                          world=world)
        return TrainPrograms(
            layout=layout, state=state, warm_step=warm, compressed_step=comp,
            wire_state=init_wire_state(layout, compress, len(mine),
                                       param_flat.device),
            compress=compress)
    if mode == "sync_psum":
        if workers < 1:
            raise ValueError(f"sync_psum mode needs 1 or more workers, got "
                             f"{workers}")
        opt = optimizer or adagrad(lr, initial_accum=INITIAL_ACCUM)
        return TrainPrograms(
            layout=None, state={"params": params, "opt": opt.init(params)},
            step=make_gba_psum_step(workers, make_loss_fn(cfg), opt,
                                    gba.staleness_tolerance, world=world),
            optimizer=opt)
    raise ValueError(f"unknown mode {mode!r}: expected "
                     f"pytree|fused|wire|sync_psum")
