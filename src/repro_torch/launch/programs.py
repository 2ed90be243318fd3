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
    With ``model`` T > 1 the step runs over a (W, T) mesh: the model's
    modules split over T model shards by the reference's rule tables
    (``distributed.tensor_parallel``), and each model shard's flat state
    is a ``ShardedFlatLayout`` of W data shards over that shard's
    parameters, W * T ``gba_apply`` launches an apply.  With W > 1 the
    params are placed by the rule tables as the reference places them
    (``place_state=True``, its default): each weight's rows held over the
    W data shards, gathered on use and its gradient reduced over ``data``
    (``distributed.fsdp``, :func:`init_fsdp_state`,
    :func:`make_fsdp_step`); ``place_state=False`` keeps them whole over
    ``data``.
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
                                  init_flat_buffer, path_leaves,
                                  path_unflatten, tree_paths)
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.core.staleness import threshold_decay
from repro_torch.distributed import fsdp, inprocess
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import model_dims
from repro_torch.distributed.tensor_parallel import ModelAxis, model_axis
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adagrad, get_optimizer, tree_map

# the paper's GBA mode runs Adam (Tab. 5.1, "Others"); the 1T MoE cannot hold
# Adam's two f32 moments at 512 chips, so it trains with Adagrad, the
# optimizer the paper uses for its async mode, with a bfloat16 accumulator
ARCH_OPTIMIZER = {"kimi-k2-1t-a32b": "adagrad"}
ARCH_ACC_DTYPE = {"kimi-k2-1t-a32b": torch.bfloat16}


def _loss_from_batch(params, cfg: ModelConfig, batch: dict,
                     tp: ModelAxis | None = None) -> torch.Tensor:
    """The LM loss of a batch of ``tokens`` and ``labels`` (B, S), over
    the cross layers' memory when the batch has one: ``image_embeds`` (B,
    T, D), or ``frames`` (B, T, D) that the params' audio encoder turns
    into it inside the loss, as the reference's.  Under a model axis
    ``tp`` ``params`` are the held model shards' trees."""
    memory = batch.get("image_embeds")
    if "frames" in batch:
        memory = T.encode_audio(params, cfg, batch["frames"], tp)
    return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                     memory=memory, tp=tp)


def make_loss_fn(cfg: ModelConfig, tp: ModelAxis | None = None
                 ) -> Callable:
    """``loss_fn(params, batch) -> scalar``, the LM loss of ``cfg`` (over
    the model axis ``tp`` where one is given): the signature of the
    worker-parallel steps and the switching harness."""
    def loss_fn(params, batch):
        # three arguments without a model axis: the signature a caller
        # may put in place of _loss_from_batch
        if tp is None:
            return _loss_from_batch(params, cfg, batch)
        return _loss_from_batch(params, cfg, batch, tp)
    return loss_fn


def loss_and_grads(cfg: ModelConfig, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """The LM loss at ``params`` (detached) and its gradient tree, each
    leaf in its param's dtype, with autograd; ``params`` are left as they
    were."""
    return _grads_of(make_loss_fn(cfg), params, batch)


def _grads_of(loss_fn: Callable, params: Any, batch: dict
              ) -> tuple[torch.Tensor, Any]:
    """``loss_fn(params, batch)`` (detached) and its gradient tree; a leaf
    the loss does not reach takes zeros, as under ``jax.grad`` (the audio
    encoder when a batch has no ``frames``)."""
    paths, leaves = zip(*tree_paths(params))
    live = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(path_unflatten(paths, live), batch)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
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
    ``tokens`` and ``labels`` (B, S) on the params' device, and the cross
    layers' memory where the model has one (``_loss_from_batch``)."""
    m = gba.buffer_size
    iota = gba.staleness_tolerance

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        params = state["params"]
        loss, grads = loss_and_grads(cfg, params, batch)
        w = threshold_decay(torch.as_tensor(token, dtype=torch.int32)
                            .reshape(1), state["gstep"], iota)[0]
        tree_map(lambda a, g: a.add_(g.to(a.dtype) * (w / m).to(a.dtype)),
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


def init_placed_train_state(params: Any, optimizer: Optimizer,
                            placement: fsdp.Placement, held: range,
                            acc_dtype: torch.dtype = torch.float32) -> dict:
    """State of the placed pytree step: ``params``, the accumulator
    ``acc`` and the optimizer's leaf state (Adam's ``m`` and ``v``,
    Adagrad's ``accum``) each held as the blocks ``[model][data]`` of the
    held model shards ``held`` and the data shards ``placement.held``, as
    the reference's ``train_state_specs`` place them (``fsdp.place``, each
    leaf cut by the rule tables, a copy of its own); Adam's ``count``, and
    ``micro`` and ``gstep``, whole.  ``params`` may be whole tensors or
    meta tensors (the dry run's shapes)."""
    blocks = fsdp.place(params, placement.specs, placement.mesh, held,
                        placement.held)
    return {
        "params": blocks,
        "opt": optimizer.init(blocks),
        "acc": tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                              device=p.device), blocks),
        "micro": 0,
        "gstep": 0,
    }


def make_placed_train_step(cfg: ModelConfig, optimizer: Optimizer,
                           gba: GBAConfig, placement: fsdp.Placement,
                           tp: ModelAxis) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)`` of the pytree
    step with its state held over the (data, model) mesh
    (:func:`init_placed_train_state`), the reference's ``build_step``
    train step.  A microstep runs the LM loss over the model axis ``tp``
    on the held blocks through ``fsdp.Microstep``: each weight gathered
    over ``data`` on use, its gradient reduced over ``data`` in float32
    into the held rows (``fsdp.grad_rows``); ``acc += g.to(acc.dtype) *
    (w / M)`` on the held rows, as :func:`make_train_step` adds it; every
    M-th microstep ``optimizer.update`` on the held blocks alone (the
    update is elementwise, so it is the whole tree's, bit for bit) and the
    accumulator zeroed.  Over R data ranks ``batch`` is the rank's rows,
    its loss its share of the batch's mean, and the loss returned the
    ranks' shares summed in rank order.  In one process at a (1, 1) mesh
    it is :func:`make_train_step` bit for bit."""
    m, iota = gba.buffer_size, gba.staleness_tolerance
    world = placement.world

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        blocks = state["params"]
        step = fsdp.Microstep(placement, blocks)
        with torch.enable_grad():
            loss = _loss_from_batch(step.views(), cfg, batch, tp)
            if world.size > 1:
                loss = loss / world.size
            torch.autograd.grad(loss, [step.anchor], allow_unused=True)
        loss = loss.detach()
        if world.size > 1:
            loss = _ranks_loss(world, loss)
        w = threshold_decay(torch.as_tensor(token, dtype=torch.int32)
                            .reshape(1), state["gstep"], iota)[0]
        summed: dict = {}
        for i, per in enumerate(state["acc"]):
            for di, block in enumerate(per):
                for j, a in enumerate(placement.layout.leaves(block)):
                    if placement.dims[j] is None:
                        key = id(step.sink[i][j])
                        if key not in summed:
                            summed[key] = fsdp.grad_rows(placement, step,
                                                         i, j, di)
                        g = summed[key]
                    else:
                        g = fsdp.grad_rows(placement, step, i, j, di)
                    a.add_(g.to(a.dtype) * (w / m).to(a.dtype))
        del step, summed
        micro = state["micro"] + 1
        is_full = micro % m == 0
        opt = state["opt"]
        if is_full:
            blocks, opt = optimizer.update(blocks, state["acc"], opt)
            tree_map(lambda a: a.zero_(), state["acc"])
        return {"params": blocks, "opt": opt, "acc": state["acc"],
                "micro": micro,
                "gstep": state["gstep"] + int(is_full)}, loss

    return train_step


def _ranks_loss(world, loss: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' shares of the loss in rank order from +0.0,
    the same bits on every rank."""
    total = torch.zeros((), dtype=loss.dtype, device=loss.device)
    for part in world.all_losses([loss]):
        total = total + part
    return total


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
    ``tokens`` and ``labels`` (B, S) on the params' device, and the cross
    layers' memory where the model has one (``_loss_from_batch``);
    ``loss_fn`` replaces the LM loss of ``cfg``.

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
            loss = _ranks_loss(world, loss)
        return {"params": params, "accum": accum,
                "buffer": new_buffer}, loss

    return train_step


def init_model_axis_state(params: Any, gba: GBAConfig, workers: int,
                          tp: ModelAxis, layer_groups: bool = True,
                          tile: int = TILE, world=inprocess
                          ) -> tuple[ShardedFlatLayout, dict]:
    """State of the fused step over a (W, T) mesh: ``params``, the held
    model shards' trees (``tp.place``: each split leaf cut to the shard's
    slice, each leaf the rules leave whole a copy, at first the one
    tensor); one ``ShardedFlatLayout`` of ``workers`` data shards over a
    model shard's tree (every model shard's has the same shapes),
    layer-grouped unless ``layer_groups`` is False; and, for the k_m held
    model shards and the k_d data shards ``world`` holds of each, ``accum``
    ``(k_m * k_d * shard_size,)`` filled with ``INITIAL_ACCUM`` and the
    buffer's ``grads`` the ``(M, k_m * k_d, shard_size)`` view of
    shard-major zeros, model shard by model shard."""
    shards = tp.place(params)
    layout = ShardedFlatLayout.from_params(
        shards[0], workers, tile,
        group_by=T.param_group_key if layer_groups else None)
    blocks = len(tp.held) * len(world.workers(workers))
    dev = layout.leaves(shards[0])[0].device
    grads = torch.zeros((blocks, gba.buffer_size, layout.shard_size),
                        dtype=torch.float32, device=dev)
    buffer = {"grads": grads.transpose(0, 1),
              "tokens": torch.zeros((gba.buffer_size,), dtype=torch.int32,
                                    device=dev),
              "fill": 0, "step": 0}
    accum = torch.full((blocks * layout.shard_size,), INITIAL_ACCUM,
                       dtype=torch.float32, device=dev)
    return layout, {"params": shards, "accum": accum, "buffer": buffer}


def make_model_axis_step(cfg: ModelConfig, gba: GBAConfig,
                         layout: ShardedFlatLayout, tp: ModelAxis,
                         lr: float = 1e-3, world=inprocess) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)`` over a (W, T)
    mesh (state of :func:`init_model_axis_state`).  The loss runs over the
    model axis (``models.transformer.lm_loss(tp=...)``); a leaf split over
    ``model`` takes its gradient on each held shard, a leaf the rules leave
    whole takes it once, on the first held shard's copy, and that one
    gradient goes to every held shard.  Each held model shard's raveled
    gradient is pushed into its k_d blocks of the buffer (over R data
    ranks reduce-scattered first, as the data-only step does); when the
    push fills the buffer, one ``gba_apply`` launch a block, k_m * k_d
    here and W * T over the mesh, updates each model shard's run of the
    flat params and its accumulator, and each shard's params are gathered
    along ``data`` alone into its tree.  The whole leaves' copies are then
    bit-identical: the same gradient, accumulator and arithmetic.  The
    loss returned is the sum of the data ranks' shares in rank order."""
    iota, m = gba.staleness_tolerance, gba.buffer_size
    loss_fn = make_loss_fn(cfg, tp)
    ranks = world.size
    share = loss_fn if ranks == 1 else (
        lambda params, batch: loss_fn(params, batch) / ranks)
    apply_shards = make_sharded_apply(layout, iota=iota)
    mine = world.workers(layout.num_shards)
    ss, k_d = layout.shard_size, len(mine)
    lo, run = mine[0] * ss, k_d * ss
    whole = [not model_dims(spec)
             for spec in path_leaves(layout.paths, tp.specs)]

    def grads_of(shards: list, batch: dict) -> tuple[torch.Tensor, list]:
        first = [x.detach().requires_grad_()
                 for x in layout.leaves(shards[0])]
        live = [first] + [[f if w else x.detach().requires_grad_()
                           for f, x, w in zip(first, layout.leaves(s),
                                              whole)]
                          for s in shards[1:]]
        wanted = first + [x for ls in live[1:]
                          for x, w in zip(ls, whole) if not w]
        with torch.enable_grad():
            loss = share([layout.unflatten(ls) for ls in live], batch)
            got = torch.autograd.grad(loss, wanted, materialize_grads=True)
        ours, rest = list(got[:len(first)]), iter(got[len(first):])
        grads = [ours] + [[g if w else next(rest) for g, w in zip(ours, whole)]
                          for _ in shards[1:]]
        return loss.detach(), [layout.unflatten(gs) for gs in grads]

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        shards, accum, buffer = state["params"], state["accum"], \
            state["buffer"]
        loss, grads = grads_of(shards, batch)
        slot = buffer["fill"] % m
        for i, g in enumerate(grads):
            run_i = world.reduce_scatter(layout.ravel(g))
            buffer["grads"][slot, i * k_d:(i + 1) * k_d].copy_(
                run_i.view(k_d, ss))
            del run_i
        del grads
        buffer["tokens"][slot] = token
        fill = buffer["fill"] + 1
        is_full = fill % m == 0
        new_buffer = {"grads": buffer["grads"], "tokens": buffer["tokens"],
                      "fill": fill, "step": buffer["step"] + int(is_full)}
        if is_full:
            flat_p = torch.empty((len(shards) * run,), dtype=torch.float32,
                                 device=accum.device)
            for i, s in enumerate(shards):
                flat_p[i * run:(i + 1) * run].copy_(
                    layout.ravel(s)[lo:lo + run])
            apply_shards(flat_p, accum, new_buffer["grads"].unbind(1),
                         new_buffer["tokens"], buffer["step"], lr)
            shards = [world.all_gather(layout, flat_p[i * run:(i + 1) * run])
                      for i in range(len(shards))]
            del flat_p
        if ranks > 1:
            loss = _ranks_loss(world, loss)
        return {"params": shards, "accum": accum,
                "buffer": new_buffer}, loss

    return train_step


def init_fsdp_state(params: Any, gba: GBAConfig, workers: int,
                    tp: ModelAxis | None = None, layer_groups: bool = True,
                    tile: int = TILE, world=inprocess
                    ) -> tuple[fsdp.Placement, dict]:
    """State of the fused step over a (W, T) mesh, W = ``workers`` > 1,
    with the params placed by the rule tables (T = 1 without a model axis
    ``tp``): ``params`` the blocks ``[model][data]`` of the held model
    shards (``tp.held``, or the one) and the data shards ``world`` holds
    (``fsdp.place``: each leaf cut to the block's rows and columns, each a
    copy of its own); the flat state of :func:`init_model_axis_state`,
    over one model shard's ``ShardedFlatLayout`` of W data shards,
    layer-grouped unless ``layer_groups`` is False: ``accum`` ``(k_m *
    k_d * shard_size,)`` filled with ``INITIAL_ACCUM`` and the buffer's
    ``grads`` ``(M, k_m * k_d, shard_size)``.  Returns (the
    ``fsdp.Placement``, state)."""
    mesh = tp.mesh if tp is not None else Mesh(("data", "model"),
                                               (workers, 1))
    specs = tp.specs if tp is not None else S.param_specs(params, mesh)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), params)
    layout = ShardedFlatLayout.from_params(
        S.place(meta, specs, mesh, 0), workers, tile,
        group_by=T.param_group_key if layer_groups else None)
    placement = fsdp.Placement.of(layout, specs, mesh, world)
    held = tp.held if tp is not None else range(1)
    blocks = fsdp.place(params, specs, mesh, held, placement.held)
    n = len(held) * len(placement.held)
    dev = layout.leaves(blocks[0][0])[0].device
    grads = torch.zeros((n, gba.buffer_size, layout.shard_size),
                        dtype=torch.float32, device=dev)
    buffer = {"grads": grads.transpose(0, 1),
              "tokens": torch.zeros((gba.buffer_size,), dtype=torch.int32,
                                    device=dev),
              "fill": 0, "step": 0}
    accum = torch.full((n * layout.shard_size,), INITIAL_ACCUM,
                       dtype=torch.float32, device=dev)
    return placement, {"params": blocks, "accum": accum, "buffer": buffer}


def make_fsdp_step(cfg: ModelConfig, gba: GBAConfig,
                   placement: fsdp.Placement, tp: ModelAxis | None = None,
                   lr: float = 1e-3, world=inprocess,
                   loss_fn: Callable | None = None) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)`` of the fused
    step with the params held over ``data`` (state of
    :func:`init_fsdp_state`).  Each microstep the loss runs on the held
    blocks through ``fsdp.Microstep`` (over the model axis ``tp`` where
    one is given): each module gathered over ``data`` on use, and each
    weight's gradient reduced over the data ranks in float32 into the
    rank's rows, which ``fsdp.push`` moves into the slot's columns of each
    held model shard's blocks of the buffer.  When the push fills the
    buffer, the held columns of the params (``fsdp.columns``), one
    ``gba_apply`` launch a (data, model) block (W * T over the mesh), and
    each block's rows cut from the updated columns (``fsdp.rows``), in
    place.  ``loss_fn(tree, batch)``, where given, replaces the LM loss
    and takes the first model shard's tree gathered whole.  Over R data
    ranks ``batch`` is the rank's rows, its loss its share of the
    batch's mean, and the loss returned the ranks' shares summed in rank
    order.  It is :func:`make_fused_train_step` (T = 1) or
    :func:`make_model_axis_step` on the same params bit for bit in one
    process, and over two data ranks."""
    iota, m = gba.staleness_tolerance, gba.buffer_size
    layout, ranks = placement.layout, world.size
    lm = loss_fn is None
    loss_fn = loss_fn or make_loss_fn(cfg, tp)
    apply_shards = make_sharded_apply(layout, iota=iota)
    k_d, ss = len(placement.held), layout.shard_size
    run = k_d * ss

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        blocks, accum, buffer = state["params"], state["accum"], \
            state["buffer"]
        step = fsdp.Microstep(placement, blocks)
        if not lm:
            params = step.whole()
        else:
            params = step.views() if tp is not None else step.views()[0]
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            if ranks > 1:
                loss = loss / ranks
            torch.autograd.grad(loss, [step.anchor], allow_unused=True)
        del params
        slot = buffer["fill"] % m
        for i, sink in enumerate(step.sink):
            fsdp.push(placement, sink,
                      buffer["grads"][slot, i * k_d:(i + 1) * k_d])
        leaves = step.leaves
        del step
        buffer["tokens"][slot] = token
        fill = buffer["fill"] + 1
        is_full = fill % m == 0
        new_buffer = {"grads": buffer["grads"], "tokens": buffer["tokens"],
                      "fill": fill, "step": buffer["step"] + int(is_full)}
        if is_full:
            flat_p = torch.empty((len(blocks) * run,), dtype=torch.float32,
                                 device=accum.device)
            for i, ls in enumerate(leaves):
                fsdp.columns(placement, ls, flat_p[i * run:(i + 1) * run])
            apply_shards(flat_p, accum, new_buffer["grads"].unbind(1),
                         new_buffer["tokens"], buffer["step"], lr)
            for i, ls in enumerate(leaves):
                fsdp.rows(placement, flat_p[i * run:(i + 1) * run], ls)
            del flat_p
        loss = loss.detach()
        if ranks > 1:
            loss = _ranks_loss(world, loss)
        return {"params": blocks, "accum": accum,
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
    fills ``state`` (``params``, ``opt``), ``step`` and ``optimizer``.
    The placed ``pytree`` step also fills ``model_axis`` and
    ``placement``, its ``params``, ``acc`` and optimizer leaves the
    blocks ``[model][data]``.
    ``fused`` over a model axis of T > 1 also fills ``model_axis``, and
    its ``state["params"]`` is the list of the held model shards' trees;
    with the params placed over ``data`` (W > 1, ``place_state``) it fills
    ``placement`` (``distributed.fsdp.Placement``, whose ``layout`` is
    ``layout``), and ``state["params"]`` holds the blocks ``[model][data]``
    of the held shards (:meth:`gather_params` puts them together)."""

    layout: Any
    state: dict
    step: Callable | None = None
    optimizer: Optimizer | None = None
    warm_step: Callable | None = None
    compressed_step: Callable | None = None
    wire_state: dict | None = None
    compress: CompressionPolicy | None = None
    model_axis: ModelAxis | None = None
    placement: fsdp.Placement | None = None

    def gather_params(self, params: Any) -> Any:
        """The held model shards' trees (a list under a model axis, else
        the one tree) of the fused state's ``params``: under FSDP the
        held blocks gathered over ``data`` (``fsdp.gather``: over ranks
        every rank of the data subgroup calls it); else ``params``
        themselves."""
        if self.placement is None:
            return params
        trees = fsdp.gather(self.placement, params)
        return trees if self.model_axis is not None else trees[0]

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
                   world=inprocess, model: int = 1,
                   place_state: bool = True) -> TrainPrograms:
    """The step(s) of ``mode`` and their state, from ``params`` (on the
    device the steps run on).

    ``pytree`` takes ``optimizer`` or, by default, the arch's
    (``ARCH_OPTIMIZER``, else Adam at ``lr``), and an accumulator in
    ``acc_dtype`` or the arch's (``ARCH_ACC_DTYPE``, else float32).  Over
    a (``workers``, ``model``) mesh larger than one device with
    ``place_state`` (the reference's ``build_step`` train step,
    ``launch.steps``) its state is held as (data, model) blocks
    (:func:`init_placed_train_state`, :func:`make_placed_train_step`);
    ``workers`` alone, or ``place_state=False``, keeps the one-device
    step.

    ``fused`` with ``workers`` > 1 splits the flat vectors into that many
    PS shards, layer-grouped unless ``layer_groups`` is False
    (``init_fused_train_state``), of which this process holds
    ``world.workers(workers)``: all of them in process, W / R on each of
    R ranks, whose steps take their R-th of each microstep's batch.  With
    ``model`` T > 1 it runs over the (``workers``, T) mesh
    (:func:`init_model_axis_state`, :func:`make_model_axis_step`): the
    process holds ``world.model_shards(T)``, and every spec the rule
    tables give runs (``distributed.tensor_parallel.model_axis``).  Only
    ``fused`` takes a model axis: the reference's wire and sync steps
    replicate over it.  With ``workers`` > 1 and ``place_state`` (the
    reference's argument, and its default) the params are placed over
    the (W, T) mesh's ``data`` axis too, as the reference's
    ``device_put`` of ``param_specs`` places them
    (:func:`init_fsdp_state`, :func:`make_fsdp_step`); with
    ``place_state=False`` they stay whole over ``data``.

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
    the workers held here (the whole batch in process), and split every
    entry of the batch, the memory too, by rows among them."""
    T.check_supported(cfg)
    placed_tree = mode == "pytree" and place_state and workers * model > 1
    if model != 1 and mode != "fused" and not placed_tree:
        raise ValueError(f"{mode} mode runs no model axis (model={model}): "
                         f"its step replicates over model")
    if mode == "pytree":
        opt = optimizer or get_optimizer(
            ARCH_OPTIMIZER.get(cfg.name, "adam"), lr)
        dt = acc_dtype or ARCH_ACC_DTYPE.get(cfg.name, torch.float32)
        if placed_tree:
            mesh = Mesh(("data", "model"), (workers, model))
            tp = model_axis(cfg, mesh, world)
            placement = fsdp.placement_of(params, tp.specs, mesh, world)
            return TrainPrograms(
                layout=placement.layout,
                state=init_placed_train_state(params, opt, placement,
                                              tp.held, dt),
                step=make_placed_train_step(cfg, opt, gba, placement, tp),
                optimizer=opt, model_axis=tp, placement=placement)
        return TrainPrograms(layout=None,
                             state=init_train_state(params, opt, dt),
                             step=make_train_step(cfg, opt, gba),
                             optimizer=opt)
    if mode == "fused":
        if workers < 1 or model < 1:
            raise ValueError(f"fused mode needs 1 or more workers and model "
                             f"shards, got {workers} x {model}")
        tp = (model_axis(cfg, Mesh(("data", "model"), (workers, model)),
                         world) if model > 1 else None)
        if workers > 1 and place_state:
            placement, state = init_fsdp_state(params, gba, workers, tp,
                                               layer_groups, world=world)
            return TrainPrograms(layout=placement.layout, state=state,
                                 step=make_fsdp_step(cfg, gba, placement,
                                                     tp, lr=lr, world=world),
                                 model_axis=tp, placement=placement)
        if model > 1:
            layout, state = init_model_axis_state(params, gba, workers, tp,
                                                  layer_groups, world=world)
            return TrainPrograms(layout=layout, state=state,
                                 step=make_model_axis_step(
                                     cfg, gba, layout, tp, lr=lr,
                                     world=world), model_axis=tp)
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
