"""Functional optimizers over dicts of tensors: SGD, Adagrad, Adam.

Counterpart of ``repro.optim.optimizers``, with the same interface:

    opt = adam(lr=6e-4)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

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


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {}

    def update(params, grads, state):
        params = tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
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

    def update(params, grads, state):
        def upd(p, g, a):
            gf = g.float()
            a = a + torch.square(gf)
            new_p = p.float() - lr * gf / (torch.sqrt(a) + eps)
            return new_p.to(p.dtype), a

        params, accum = _unzip(
            tree_map(upd, params, grads, state["accum"]), 2)
        return params, {"accum": accum}

    return Optimizer("adagrad", init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    """``count`` is an int32 0-d tensor; the bias corrections are float32
    powers of it."""
    def init(params):
        device = next(tree_leaves(params)).device
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(params, grads, state):
        count = state["count"] + 1
        bc1 = 1.0 - torch.pow(b1, count.float())
        bc2 = 1.0 - torch.pow(b2, count.float())

        def upd(p, g, m, v):
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return (p.float() - step).to(p.dtype), m, v

        params, m, v = _unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return params, {"m": m, "v": v, "count": count}

    return Optimizer("adam", init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    return {"sgd": sgd, "adagrad": adagrad, "adam": adam}[name](lr)
