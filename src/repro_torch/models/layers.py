"""Dense transformer layers: RMSNorm, RoPE, causal GQA attention and the
gated (SwiGLU) MLP.

Counterpart of the dense subset of ``repro.models.layers``, with its
parameter names, shapes and arithmetic.  ``init_*`` builds a dict of
tensors, ``*_fwd`` applies it.  Attention is written as the reference
writes it (einsum, scores in float32 masked with ``_MASK_VALUE``, softmax,
probabilities cast to the value dtype), not through a fused attention
operator, so that the numbers are the reference's.  Where the reference
asks for ``preferred_element_type=float32``, the port casts both operands
to float32: a bfloat16 product is exact in float32, so the sums are float32
sums of the same products.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

Params = dict[str, Any]

_MASK_VALUE = -2.0e38
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dense_init(gen: torch.Generator, shape: tuple[int, ...],
                dtype: torch.dtype, scale: float | None = None
                ) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (1/sqrt(fan_in) by default), drawn in
    float32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def init_norm(cfg: ModelConfig, device: torch.device) -> Params:
    """RMSNorm: a float32 ``scale`` of zeros (the gain is ``1 + scale``)."""
    return {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                 device=device)}


def norm_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gemma-style RMSNorm in float32, eps 1e-6, back in ``x``'s dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + 1e-6) * (1.0 + p["scale"])
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Rotates the two halves of the head in float32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    return {
        "wq": _dense_init(gen, (cfg.d_model, cfg.num_heads, hd), dt),
        "wk": _dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), dt),
        "wv": _dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), dt),
        "wo": _dense_init(gen, (cfg.num_heads, hd, cfg.d_model), dt),
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (B,S,Hkv,G,hd), k/v: (B,T,Hkv,hd), mask: (B,S,T) bool ->
    (B,S,Hkv,G,hd) float32."""
    hd = q.shape[-1]
    scores = torch.einsum("bsngh,btnh->bnsgt", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    # scores are (B,Hkv,S,G,T); the mask broadcasts as (B,1,S,1,T)
    scores = torch.where(mask[:, None, :, None, :], scores, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnsgt,btnh->bsngh", probs.to(v.dtype).float(),
                        v.float())


def attention_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention.  x: (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    G = cfg.num_heads // cfg.num_kv_heads
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", x, p["wk"])
    v = torch.einsum("btd,dnh->btnh", x, p["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    mask = positions[:, :, None] >= positions[:, None, :]
    q = q.reshape(B, S, cfg.num_kv_heads, G, cfg.resolved_head_dim)
    out = _sdpa(q, k, v, mask)
    out = out.reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)
    # float32 attention output times the weight: float32, as jnp promotes
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].float()).to(x.dtype)


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    return {
        "wi_gate": _dense_init(gen, (cfg.d_model, cfg.d_ff), dt),
        "wi_up": _dense_init(gen, (cfg.d_model, cfg.d_ff), dt),
        "wo": _dense_init(gen, (cfg.d_ff, cfg.d_model), dt),
    }


def mlp_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return (h @ p["wo"]).to(x.dtype)
