"""The fused flat-buffer GBA train step of the LM: ``build_programs``.

Counterpart of ``repro.launch.programs`` for ``mode="fused"`` on one
device.  The model's params stay a tree (the forward consumes them); the
Adagrad accumulator and the M-slot gradient buffer live flat
(``repro_torch.core.gba``).  Each microstep computes the LM loss and its
gradient, ravels the gradient into the buffer; on every M-th microstep ONE
``gba_apply`` launch aggregates the buffer with the token-control weights
of Eq. (1) and applies Adagrad to the whole flat vector.

The reference also builds the pytree, wire and sync_psum programs and the
sharded fused path over a mesh; the port has none of them yet (ROADMAP.md)
and raises for them.  PyTorch runs eagerly, so there is nothing to jit: the
"program" is the step function, and it updates the buffer and the
accumulator in place where the reference donates them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import GBAConfig, ModelConfig
from repro_torch.core.gba import FlatLayout, flat_buffer_push, init_flat_buffer
from repro_torch.kernels import ops
from repro_torch.models import transformer as T


def _loss_from_batch(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return T.lm_loss(params, cfg, batch["tokens"], batch["labels"])


# Adagrad's initial accumulator (the reference's default; no ported caller
# sets another)
INITIAL_ACCUM = 0.1


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
        live = [x.detach().requires_grad_() for x in layout.leaves(params)]
        with torch.enable_grad():
            loss = _loss_from_batch(layout.unflatten(live), cfg, batch)
            grads = torch.autograd.grad(loss, live)
        del live
        new_buffer, is_full = flat_buffer_push(
            buffer, layout.ravel(layout.unflatten(list(grads))), token)
        del grads
        if is_full:
            flat_p = layout.ravel(params)
            ops.gba_apply_flat(flat_p, accum, new_buffer["grads"],
                               new_buffer["tokens"], buffer["step"], lr,
                               iota=iota)
            params = layout.unravel(flat_p)
        return {"params": params, "accum": accum,
                "buffer": new_buffer}, loss.detach()

    return train_step


@dataclass
class TrainPrograms:
    """What a launcher needs to run the fused step: the step, its state
    and the flat layout."""

    layout: FlatLayout
    state: dict
    step: Callable


def build_programs(cfg: ModelConfig, gba: GBAConfig, *, params: Any,
                   mode: str = "fused", lr: float = 1e-3) -> TrainPrograms:
    """The fused flat-buffer step and its state, from ``params`` (on the
    device the step runs on).  The reference's other modes are not ported
    and raise ``NotImplementedError``."""
    if mode != "fused":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: the port has the single-device "
            f"fused flat-buffer step only (see ROADMAP.md)")
    T.check_supported(cfg)
    layout, state = init_fused_train_state(params, gba)
    return TrainPrograms(layout=layout, state=state,
                         step=make_fused_train_step(cfg, gba, layout, lr=lr))
