"""Dense tower of the recommendation models.

Counterpart of ``_mlp_init`` and ``_mlp_fwd`` in ``repro.models.recsys``:
the tower is a plain dict of tensors ``w{i}`` (in, out) and ``b{i}`` (out,),
key for key as in the JAX package, so checkpoints map across.  DeepFM,
YouTubeDNN, DIEN and the loss are not ported yet.
"""
from __future__ import annotations

import math

import torch

Params = dict[str, torch.Tensor]


def _mlp_init(dims: tuple[int, ...], *, generator: torch.Generator,
              device: torch.device) -> Params:
    """``w{i}`` ~ Normal(0, 1) / sqrt(fan_in), drawn on the CPU from
    ``generator``; zero biases."""
    n = len(dims) - 1
    w = {f"w{i}": (torch.randn((dims[i], dims[i + 1]), generator=generator)
                   / math.sqrt(dims[i])).to(device) for i in range(n)}
    b = {f"b{i}": torch.zeros((dims[i + 1],), device=device)
         for i in range(n)}
    return w | b


def _mlp_fwd(p: Params, x: torch.Tensor, n: int,
             final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU between layers (and after the last
    only with ``final_act``)."""
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x
