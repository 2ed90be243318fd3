"""Dense transformer layers: RMSNorm, RoPE, causal GQA attention (full
sequence, and one-token decode against a KV cache) and the gated (SwiGLU)
MLP.

Counterpart of the dense subset of ``repro.models.layers``, with its
parameter names, shapes and arithmetic.  ``init_*`` builds a dict of
tensors, ``*_fwd`` applies it.  Attention is written as the reference
writes it (einsum, scores in float32 masked with ``_MASK_VALUE``, softmax,
probabilities cast to the value dtype), not through a fused attention
operator, so that the numbers are the reference's.  Where the reference
asks for ``preferred_element_type=float32``, the port casts both operands
to float32: a bfloat16 product is exact in float32, so the sums are float32
sums of the same products.  The one exception is the decode step at a
scalar position, which runs the ``flash_decode`` kernel (see
:func:`attention_decode`).

Decode caches are the reference's global-layer layout, ``{"k", "v"}`` of
``(B, cache_len, KV, hd)`` with RoPE'd keys; :func:`attention_decode`
writes them in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

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
                  positions: torch.Tensor, *, return_kv: bool = False):
    """Full-sequence causal self-attention.  x: (B,S,D) -> (B,S,D).  With
    ``return_kv`` also returns the (RoPE'd) k and v, (B,S,KV,hd) each, for
    the decode cache."""
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
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].float()).to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def kv_to_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                seq_len: int, cache_len: int) -> Params:
    """Full-sequence k/v (B,S,KV,hd) as a decode cache of capacity
    ``cache_len``: zero-padded after position ``seq_len - 1`` and cast to
    the model dtype (the reference's global-layer branch)."""
    pad = cache_len - seq_len
    if pad < 0:
        raise ValueError(f"cache_len {cache_len} < prompt {seq_len}")
    dt = dtype_of(cfg)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": k.to(dt), "v": v.to(dt)}


def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int,
                    device: torch.device) -> Params:
    """An empty (zero) KV cache of one global attention layer, in the
    model dtype."""
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _write_rows(cache: torch.Tensor, slots: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slots[b]] = new[b]`` in place, for every row whose slot
    is below L; a row at or past L is dropped, as the reference's
    ``.at[...].set(mode="drop")`` drops it (an engine slot that finished
    can reach ``max_len``).  No host round trip: the dropped rows write
    back what the cache held."""
    B, L = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    keep = (slots < L)[:, None, None]
    slot = slots.clamp(max=L - 1)
    cache[rows, slot] = torch.where(keep, new.to(cache.dtype),
                                    cache[rows, slot])


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Params, pos: torch.Tensor
                     ) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,D); ``pos`` a 0-d integer tensor (every
    sequence at one position, the fixed-batch loop) or a (B,) vector (one
    position a slot, the continuous-batching engine).  The new k and v are
    written into ``cache`` in place at each row's position (rows at or
    past the cache's length are dropped); returns ``(y (B,1,D), cache)``.

    A scalar ``pos`` goes through the ``flash_decode`` kernel
    (``ops.flash_decode``), whose output is in q's dtype and whose
    probabilities stay in float32, then through the output projection in
    that dtype.  A (B,) ``pos`` runs the reference's masked ``_sdpa``,
    which casts the probabilities to the value dtype and keeps a float32
    output for the projection.  In float32 the two routes agree to float32
    rounding; in bfloat16 they differ by those two roundings, about one
    bf16 ulp of the attention output."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    G = cfg.num_heads // KV
    pos_vec = pos.expand(B) if pos.dim() == 0 else pos
    posb = pos_vec[:, None]                                   # (B, 1)
    q = rope(torch.einsum("bsd,dnh->bsnh", x, p["wq"]), posb, cfg.rope_theta)
    k_new = rope(torch.einsum("bsd,dnh->bsnh", x, p["wk"]), posb,
                 cfg.rope_theta)
    v_new = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    k_cache, v_cache = cache["k"], cache["v"]
    _write_rows(k_cache, pos_vec, k_new[:, 0])
    _write_rows(v_cache, pos_vec, v_new[:, 0])
    if pos.dim() == 0:
        out = ops.flash_decode(q.reshape(B, KV, G, hd), k_cache, v_cache, pos)
        out = out.reshape(B, 1, cfg.num_heads, hd)
        y = torch.einsum("bsnh,nhd->bsd", out, p["wo"]).to(x.dtype)
    else:
        L = k_cache.shape[1]
        valid = torch.arange(L, device=x.device)[None, :] <= posb  # (B, L)
        out = _sdpa(q.reshape(B, 1, KV, G, hd), k_cache, v_cache,
                    valid[:, None, :])
        out = out.reshape(B, 1, cfg.num_heads, hd)
        y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].float()).to(x.dtype)
    return y, {"k": k_cache, "v": v_cache}


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
