"""Functional optimizers over dicts of tensors: SGD, Adagrad, Adam.

Counterpart of ``repro.optim.optimizers``, with the same interface:

    opt = adam(lr=6e-4)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``update(..., lr_override=schedule(step))`` takes a learning rate for one
call (``repro_torch.optim.schedules``): a float, or a float32 0-d tensor.
SGD applies both as JAX does to a bf16 param: a float is rounded to bf16
first, and a tensor makes the step compute in float32 and cast back to the
param's dtype (PyTorch alone would keep that product in bf16).

``params`` and ``grads`` are nested dicts and lists of tensors of the same
structure (a model's ``prefix`` layers are a list).
``update`` returns new tensors and never writes into its arguments: the
replay trainer keeps earlier parameter versions by reference
(``repro_torch.core.trainer.VersionRing``), and an update in place would
turn every stored version into the current one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

Params = Any
State = Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists of the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves of nested dicts and lists, in their insertion order."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from tree_leaves(v)
    else:
        yield tree


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], State]
    update: Callable[..., tuple[Params, State]]


def _unzip(tree: Any, n: int) -> list[Any]:
    """A tree of n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, list):
        parts = [_unzip(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree)


def _global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / norm)`` (each leaf in its
    dtype), and ``norm``: the float32 root of the leaves' sums of squares,
    added in ``tree_leaves`` order."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _weak(c: float, like: torch.Tensor) -> float:
    """A Python float as JAX applies a weakly typed scalar to ``like``:
    rounded to its dtype first (a no-op for float32)."""
    return torch.tensor(c, dtype=like.dtype).item()


def _minus_scaled(p: torch.Tensor, lr: Any, x: torch.Tensor) -> torch.Tensor:
    """``p - lr * x`` in p's dtype.  A tensor ``lr`` promotes as in JAX, where
    a float32 0-d array times a bf16 array computes in float32."""
    if isinstance(lr, torch.Tensor):
        dt = torch.promote_types(torch.promote_types(p.dtype, x.dtype),
                                 lr.dtype)
        return (p.to(dt) - lr.to(dt) * x.to(dt)).to(p.dtype)
    return (p - _weak(lr, x) * x).to(p.dtype)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """With ``momentum`` the state is ``{"mom": ...}``, zeros of each
    param's shape and dtype, and the step is ``lr * (momentum * mom + g)``.
    The params keep their dtype: the JAX package's momentum path turns bf16
    params into float32 under a float32 ``lr_override``."""
    def init(params):
        if momentum:
            return {"mom": tree_map(torch.zeros_like, params)}
        return {}

    def update(params, grads, state, lr_override=None):
        step_lr = lr if lr_override is None else lr_override
        if momentum:
            mom = tree_map(lambda m, g: _weak(momentum, m) * m + g,
                           state["mom"], grads)
            params = tree_map(lambda p, m: _minus_scaled(p, step_lr, m),
                              params, mom)
            return params, {"mom": mom}
        params = tree_map(lambda p, g: _minus_scaled(p, step_lr, g),
                          params, grads)
        return params, state

    return Optimizer("sgd", init, update)


def adagrad(lr: float, eps: float = 1e-10, initial_accum: float = 0.1
            ) -> Optimizer:
    """The accumulator starts at ``initial_accum``; ``eps`` is added
    outside the square root."""
    def init(params):
        return {"accum": tree_map(
            lambda p: torch.full(p.shape, initial_accum, dtype=torch.float32,
                                 device=p.device), params)}

    def update(params, grads, state, lr_override=None):
        step_lr = lr if lr_override is None else lr_override

        def upd(p, g, a):
            gf = g.float()
            a = a + torch.square(gf)
            new_p = p.float() - step_lr * gf / (torch.sqrt(a) + eps)
            return new_p.to(p.dtype), a

        params, accum = _unzip(
            tree_map(upd, params, grads, state["accum"]), 2)
        return params, {"accum": accum}

    return Optimizer("adagrad", init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """``count`` is an int32 0-d tensor; the bias corrections are float32
    powers of it.  ``weight_decay`` adds ``lr * weight_decay * p`` to the
    step (decoupled, as AdamW)."""
    def init(params):
        device = next(tree_leaves(params)).device
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(params, grads, state, lr_override=None):
        step_lr = lr if lr_override is None else lr_override
        count = state["count"] + 1
        bc1 = 1.0 - torch.pow(b1, count.float())
        bc2 = 1.0 - torch.pow(b2, count.float())

        def upd(p, g, m, v):
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            step = step_lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + step_lr * weight_decay * p.float()
            return (p.float() - step).to(p.dtype), m, v

        params, m, v = _unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return params, {"m": m, "v": v, "count": count}

    return Optimizer("adam", init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "adagrad": adagrad, "adam": adam}[name](lr, **kw)
