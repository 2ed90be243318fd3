"""The paper's recommendation models, as functions of ``(params, batch)``.

Counterpart of ``repro.models.recsys``.  Parameters are plain dicts of
tensors, key for key as in the JAX package (``embed``, ``linear``,
``bias``, ``mlp/w{i}``, ``mlp/b{i}``), so checkpoints and
``repro_torch.convert`` map across and the trainer's sparse/dense split
(``EMBED_KEYS``) reads the same names.  A batch is a dict of tensors:
``fields`` (B, num_fields) int32 hashed ids and ``label`` (B,) float32.

Ported: the dense tower and DeepFM (the quickstart's model).  YouTubeDNN
and DIEN (the GRU scan and target attention) come with the
continual-training benches in a later slice of the port.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.recsys import RecsysConfig
from repro_torch.kernels.runtime import resolve_device

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


# ---------------------------------------------------------------------------
# DeepFM (Criteo task)
# ---------------------------------------------------------------------------

def init_deepfm(cfg: RecsysConfig, *, generator: torch.Generator,
                device: torch.device) -> Params:
    """Normal(0, 0.01) ``embed`` (capacity, dim) and ``linear``
    (capacity,), a 0-d zero ``bias`` and the tower
    ``num_fields * dim -> *mlp_dims -> 1``, drawn on the CPU from
    ``generator`` in that order."""
    deep_in = cfg.num_fields * cfg.embed_dim
    dims = (deep_in, *cfg.mlp_dims, 1)
    embed = torch.randn((cfg.hash_capacity, cfg.embed_dim),
                        generator=generator) * 0.01
    linear = torch.randn((cfg.hash_capacity,), generator=generator) * 0.01
    return {
        "embed": embed.to(device),
        "linear": linear.to(device),
        "bias": torch.zeros((), device=device),
        "mlp": _mlp_init(dims, generator=generator, device=device),
    }


def deepfm_logit(params: Params, cfg: RecsysConfig, batch: dict
                 ) -> torch.Tensor:
    ids = batch["fields"]                                   # (B, F)
    e = params["embed"][ids]                                # (B, F, D)
    # first order
    first = params["linear"][ids].sum(dim=1)                # (B,)
    # FM second order: 0.5 * ((sum e)^2 - sum e^2)
    s = e.sum(dim=1)
    fm = 0.5 * (torch.square(s) - torch.square(e).sum(dim=1)).sum(dim=-1)
    # deep
    deep_in = e.reshape(e.shape[0], -1)
    n = len(cfg.mlp_dims) + 1
    deep = _mlp_fwd(params["mlp"], deep_in, n)[:, 0]
    return params["bias"] + first + fm + deep


# ---------------------------------------------------------------------------
# uniform interface
# ---------------------------------------------------------------------------

_INIT = {"deepfm": init_deepfm}
_LOGIT = {"deepfm": deepfm_logit}


def _not_ported(model: str) -> NotImplementedError:
    return NotImplementedError(
        f"model {model!r} is not ported yet: YouTubeDNN and DIEN come with "
        f"the continual-training benches in a later slice of the port; "
        f"ported: {sorted(_INIT)}")


def init_recsys(cfg: RecsysConfig, *, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Fresh parameters of ``cfg.model``, drawn on the CPU from
    ``generator`` (so a seed gives the same parameters on every device)
    and moved to ``device``."""
    dev = resolve_device(device)
    if cfg.model not in _INIT:
        raise _not_ported(cfg.model)
    return _INIT[cfg.model](cfg, generator=generator, device=dev)


def recsys_logit(params: Params, cfg: RecsysConfig, batch: dict
                 ) -> torch.Tensor:
    if cfg.model not in _LOGIT:
        raise _not_ported(cfg.model)
    return _LOGIT[cfg.model](params, cfg, batch)


def bce_loss(params: Params, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the JAX package's stable
    form ``max(x, 0) - x * y + log1p(exp(-|x|))``.  ``torch.maximum``
    splits the gradient at a tie as ``jnp.maximum`` does."""
    logit = recsys_logit(params, cfg, batch)
    label = batch["label"]
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                      - logit * label
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def sparse_dense_split(params: Params) -> tuple[set[str], set[str]]:
    """Top-level param names belonging to the sparse vs dense module."""
    sparse = {k for k in params if k in ("embed", "linear")}
    dense = set(params) - sparse
    return sparse, dense
