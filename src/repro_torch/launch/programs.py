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
    vector.
``wire``
    W PS workers, each also a shard, in one process on one device
    (``repro_torch.core.gba_shard_map``): per global step every worker
    takes the gradient of its own slice of the batch, routes it per layer
    group to the shards, optionally over the quantized wire
    (``repro_torch.core.compression``), and each shard applies with one
    ``gba_apply`` launch.  ``(warm_step, compressed_step)`` are two step
    functions, switched by the launcher at ``compress.warmup_steps``.
``sync_psum``
    W workers in one process on one device
    (``core.gba_shard_map.make_gba_psum_step``): per global step every
    worker's gradient of its own slice of the batch, scaled by its Eq. (1)
    weight over W, summed over the workers in order, then Adagrad (PyTorch
    operators, as in the reference) on the tree.  The switching harness's
    sync mode.

The reference's sharded fused path over a mesh is not ported
(ROADMAP.md).  PyTorch runs eagerly, so there is nothing to jit: a "program"
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
from repro_torch.core.flat_sharded import TILE, ShardedFlatLayout
from repro_torch.core.gba import (FlatLayout, flat_buffer_push,
                                  init_flat_buffer, path_unflatten,
                                  tree_paths)
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.core.staleness import threshold_decay
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
    paths, leaves = zip(*tree_paths(params))
    live = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = _loss_from_batch(path_unflatten(paths, live), cfg, batch)
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


def init_fused_train_state(params: Any, gba: GBAConfig
                           ) -> tuple[FlatLayout, dict]:
    """State of the fused step on the params' device: ``params`` (the
    tree), ``accum`` (N,) float32 filled with ``INITIAL_ACCUM``, and the
    flat ``buffer``.  Returns (layout, state)."""
    layout, buffer = init_flat_buffer(params, gba.buffer_size)
    accum = torch.full((layout.total,), INITIAL_ACCUM, dtype=torch.float32,
                       device=buffer["grads"].device)
    return layout, {"params": params, "accum": accum, "buffer": buffer}


def make_fused_train_step(cfg: ModelConfig, gba: GBAConfig,
                          layout: FlatLayout, lr: float = 1e-3) -> Callable:
    """``train_step(state, batch, token) -> (state, loss)``: push the
    raveled gradient; when the push fills the buffer, ONE ``gba_apply``
    launch weighs each slot against the step *before* the push and updates
    the flat params and the accumulator.  The params are raveled and
    unraveled only on that microstep; on the others ``params`` and
    ``accum`` come back as the very tensors that went in.  ``batch`` holds
    ``tokens`` and ``labels`` (B, S) on the params' device."""
    iota = gba.staleness_tolerance

    def train_step(state: dict, batch: dict, token: int
                   ) -> tuple[dict, torch.Tensor]:
        params, accum, buffer = state["params"], state["accum"], \
            state["buffer"]
        loss, grads = loss_and_grads(cfg, params, batch)
        new_buffer, is_full = flat_buffer_push(buffer, layout.ravel(grads),
                                               token)
        del grads
        if is_full:
            flat_p = layout.ravel(params)
            ops.gba_apply_flat(flat_p, accum, new_buffer["grads"],
                               new_buffer["tokens"], buffer["step"], lr,
                               iota=iota)
            params = layout.unravel(flat_p)
        return {"params": params, "accum": accum,
                "buffer": new_buffer}, loss

    return train_step


def make_wire_psum_steps(cfg: ModelConfig, gba: GBAConfig,
                         layout: ShardedFlatLayout, workers: int, *,
                         compress: CompressionPolicy | None = None,
                         lr: float = 1e-3) -> tuple[Callable, Callable]:
    """``(warm_step, compressed_step)`` of the worker-parallel
    layer-grouped step (``core.gba_shard_map``) on the LM loss: with a
    lossy policy, the float32 warmup step and the quantized one; with
    ``compress=None`` or scheme ``"none"``, one uncompressed step twice."""
    def build(warm: bool) -> Callable:
        return make_gba_fused_psum_step(
            workers, make_loss_fn(cfg), layout,
            iota=gba.staleness_tolerance, lr=lr, compress=compress,
            warm=warm)

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
    ``compressed_step`` and ``wire_state``; ``sync_psum`` fills ``state``
    (``params``, ``opt``), ``step`` and ``optimizer``."""

    layout: Any
    state: dict
    step: Callable | None = None
    optimizer: Optimizer | None = None
    warm_step: Callable | None = None
    compressed_step: Callable | None = None
    wire_state: dict | None = None


def build_programs(cfg: ModelConfig, gba: GBAConfig, *, params: Any,
                   mode: str = "fused", lr: float = 1e-3,
                   optimizer: Optimizer | None = None,
                   acc_dtype: torch.dtype | None = None,
                   workers: int = 1,
                   compress: CompressionPolicy | None = None,
                   layer_groups: bool = True) -> TrainPrograms:
    """The step(s) of ``mode`` and their state, from ``params`` (on the
    device the steps run on).

    ``pytree`` takes ``optimizer`` or, by default, the arch's
    (``ARCH_OPTIMIZER``, else Adam at ``lr``), and an accumulator in
    ``acc_dtype`` or the arch's (``ARCH_ACC_DTYPE``, else float32).

    ``wire`` runs ``workers`` PS workers and shards: the layout is a
    ``ShardedFlatLayout`` over ``TILE``, layer-grouped by
    ``models.transformer.param_group_key`` unless ``layer_groups`` is
    False; ``param_flat`` is the raveled params, ``accum`` is filled with
    ``INITIAL_ACCUM``.

    ``sync_psum`` runs ``workers`` workers with ``optimizer`` or, by
    default, Adagrad at ``lr`` with ``INITIAL_ACCUM``, as the reference's
    ``build_programs(mode="sync_psum")``."""
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
        layout, state = init_fused_train_state(params, gba)
        return TrainPrograms(layout=layout, state=state,
                             step=make_fused_train_step(cfg, gba, layout,
                                                        lr=lr))
    if mode == "wire":
        if workers < 2:
            raise ValueError(f"wire mode needs 2 or more workers, got "
                             f"{workers}")
        layout = ShardedFlatLayout.from_params(
            params, workers, TILE,
            group_by=T.param_group_key if layer_groups else None)
        param_flat = layout.ravel(params)
        state = {"param_flat": param_flat,
                 "accum": torch.full_like(param_flat, INITIAL_ACCUM)}
        warm, comp = make_wire_psum_steps(cfg, gba, layout, workers,
                                          compress=compress, lr=lr)
        return TrainPrograms(
            layout=layout, state=state, warm_step=warm, compressed_step=comp,
            wire_state=init_wire_state(layout, compress, workers,
                                       param_flat.device))
    if mode == "sync_psum":
        if workers < 1:
            raise ValueError(f"sync_psum mode needs 1 or more workers, got "
                             f"{workers}")
        opt = optimizer or adagrad(lr, initial_accum=INITIAL_ACCUM)
        return TrainPrograms(
            layout=None, state={"params": params, "opt": opt.init(params)},
            step=make_gba_psum_step(workers, make_loss_fn(cfg), opt,
                                    gba.staleness_tolerance),
            optimizer=opt)
    raise ValueError(f"unknown mode {mode!r}: expected "
                     f"pytree|fused|wire|sync_psum")
