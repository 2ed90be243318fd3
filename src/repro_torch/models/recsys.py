"""The paper's recommendation models, as functions of ``(params, batch)``.

Counterpart of ``repro.models.recsys``: DeepFM (Criteo), YouTubeDNN
(Private) and DIEN (Alimama), the three models of the paper's Tab. 5.1.
Parameters are plain dicts of tensors, key for key as in the JAX package
(``embed``, ``linear``, ``bias``, ``mlp/w{i}``, ``mlp/b{i}``, ``gru/wx``,
``gru/wh``, ``gru/b``, ``att_w``), so checkpoints and
``repro_torch.convert`` map across and the trainer's sparse/dense split
(``EMBED_KEYS``) reads the same names.  A batch is a dict of tensors:
``fields`` (B, num_fields) int32 hashed ids, ``label`` (B,) float32 and,
for YouTubeDNN and DIEN, ``behavior`` (B, behavior_len) and ``target``
(B,) int32 hashed ids.

Every logit is a plain function of tensors with no in-place update and no
host read, so the replay trainer can take per-slot gradients under
``torch.func.vmap(grad_and_value)``.  DIEN's GRU is therefore written out
step by step rather than through ``nn.GRU``, which has no batching rule
and puts its hidden-side bias inside the reset gate's product.
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
# YouTubeDNN (Private task)
# ---------------------------------------------------------------------------

def init_youtubednn(cfg: RecsysConfig, *, generator: torch.Generator,
                    device: torch.device) -> Params:
    """Normal(0, 0.01) ``embed`` (capacity, dim) and the tower
    ``(num_fields + 2) * dim -> *mlp_dims -> 1`` (fields, pooled
    behaviour, target), drawn on the CPU from ``generator`` in that
    order."""
    mlp_in = (cfg.num_fields + 2) * cfg.embed_dim
    dims = (mlp_in, *cfg.mlp_dims, 1)
    embed = torch.randn((cfg.hash_capacity, cfg.embed_dim),
                        generator=generator) * 0.01
    return {"embed": embed.to(device),
            "mlp": _mlp_init(dims, generator=generator, device=device)}


def youtubednn_logit(params: Params, cfg: RecsysConfig, batch: dict
                     ) -> torch.Tensor:
    e_fields = params["embed"][batch["fields"]]             # (B, F, D)
    e_beh = params["embed"][batch["behavior"]]              # (B, L, D)
    e_tgt = params["embed"][batch["target"]]                # (B, D)
    pooled = e_beh.mean(dim=1)
    x = torch.cat([e_fields.reshape(e_fields.shape[0], -1), pooled, e_tgt],
                  dim=-1)
    n = len(cfg.mlp_dims) + 1
    return _mlp_fwd(params["mlp"], x, n)[:, 0]


# ---------------------------------------------------------------------------
# DIEN (Alimama task): GRU interest extraction and target attention (lite)
# ---------------------------------------------------------------------------

def _gru_init(d_in: int, d_h: int, *, generator: torch.Generator,
              device: torch.device) -> Params:
    """``wx`` (d_in, 3 d_h) and ``wh`` (d_h, 3 d_h) ~ Normal(0, 1) /
    sqrt(fan_in), gates in the order r, z, n; one zero bias ``b`` on the
    input side."""
    wx = torch.randn((d_in, 3 * d_h), generator=generator) / math.sqrt(d_in)
    wh = torch.randn((d_h, 3 * d_h), generator=generator) / math.sqrt(d_h)
    return {"wx": wx.to(device), "wh": wh.to(device),
            "b": torch.zeros((3 * d_h,), device=device)}


def _gru_scan(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """The reference's GRU over ``xs`` (B, L, Din) from a zero state:
    ``gx = x @ wx + b``, ``gh = h @ wh``, ``n = tanh(gx_n + r * gh_n)``,
    ``h = (1 - z) * n + z * h``.  Returns the hidden states (B, L, Dh)."""
    d_h = p["wh"].shape[0]
    h = torch.zeros((xs.shape[0], d_h), dtype=xs.dtype, device=xs.device)
    hs = []
    for t in range(xs.shape[1]):
        gx = xs[:, t] @ p["wx"] + p["b"]
        gh = h @ p["wh"]
        r = torch.sigmoid(gx[:, :d_h] + gh[:, :d_h])
        z = torch.sigmoid(gx[:, d_h:2 * d_h] + gh[:, d_h:2 * d_h])
        n = torch.tanh(gx[:, 2 * d_h:] + r * gh[:, 2 * d_h:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def init_dien(cfg: RecsysConfig, *, generator: torch.Generator,
              device: torch.device) -> Params:
    """Normal(0, 0.01) ``embed``, the GRU, ``att_w`` (D, D) ~ Normal(0, 1)
    / sqrt(D) and the tower ``(num_fields + 2) * D -> *mlp_dims -> 1``
    (fields, final interest, target), drawn on the CPU from ``generator``
    in that order."""
    d = cfg.embed_dim
    dims = (cfg.num_fields * d + d + d, *cfg.mlp_dims, 1)
    embed = torch.randn((cfg.hash_capacity, d), generator=generator) * 0.01
    gru = _gru_init(d, d, generator=generator, device=device)
    att_w = torch.randn((d, d), generator=generator) / math.sqrt(d)
    return {"embed": embed.to(device), "gru": gru, "att_w": att_w.to(device),
            "mlp": _mlp_init(dims, generator=generator, device=device)}


def dien_logit(params: Params, cfg: RecsysConfig, batch: dict
               ) -> torch.Tensor:
    e_fields = params["embed"][batch["fields"]]
    e_beh = params["embed"][batch["behavior"]]              # (B, L, D)
    e_tgt = params["embed"][batch["target"]]                # (B, D)
    hs = _gru_scan(params["gru"], e_beh)                    # (B, L, D)
    # target-conditioned attention over the interest states
    att = torch.einsum("bld,de,be->bl", hs, params["att_w"], e_tgt)
    att = torch.softmax(att, dim=-1)
    interest = torch.einsum("bl,bld->bd", att, hs)
    x = torch.cat([e_fields.reshape(e_fields.shape[0], -1), interest,
                   e_tgt], dim=-1)
    n = len(cfg.mlp_dims) + 1
    return _mlp_fwd(params["mlp"], x, n)[:, 0]


# ---------------------------------------------------------------------------
# uniform interface
# ---------------------------------------------------------------------------

_INIT = {"deepfm": init_deepfm, "youtubednn": init_youtubednn,
         "dien": init_dien}
_LOGIT = {"deepfm": deepfm_logit, "youtubednn": youtubednn_logit,
          "dien": dien_logit}


def init_recsys(cfg: RecsysConfig, *, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Fresh parameters of ``cfg.model``, drawn on the CPU from
    ``generator`` (so a seed gives the same parameters on every device)
    and moved to ``device``."""
    dev = resolve_device(device)
    return _INIT[cfg.model](cfg, generator=generator, device=dev)


def recsys_logit(params: Params, cfg: RecsysConfig, batch: dict
                 ) -> torch.Tensor:
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
