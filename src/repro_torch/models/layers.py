"""Transformer layers: RMSNorm and layernorm, RoPE, causal GQA attention
(global or sliding-window, with an optional softcap; full sequence, and
one-token decode against a KV cache), cross-attention over a memory, the
gated (SwiGLU) MLP, the top-k MoE FFN and the Mamba2/SSD mixer (full
sequence by the chunked SSD scan, and the one-token recurrent update).

Counterpart of ``repro.models.layers``, with its parameter names, shapes
and arithmetic, its ``attn_q_chunk`` and ``mamba_split_proj`` variants
included.  ``*_spec`` describes a
module's parameters as a dict of :class:`Leaf` (shape, dtype, and how the
value is drawn), which ``models.transformer.init_model`` materialises;
``*_fwd`` applies the tensors.  Attention is written as the reference
writes it (einsum, scores in float32, softcapped, masked with
``_MASK_VALUE``, softmax, probabilities cast to the value dtype), not
through a fused attention operator, so that the numbers are the
reference's.  Where the reference asks for
``preferred_element_type=float32``, the port casts both operands to
float32: a bfloat16 product is exact in float32, so the sums are float32
sums of the same products.  The exceptions are the decode step of a
global layer at a scalar position and the cross-attention decode, which
run the ``flash_decode`` kernel (see :func:`attention_decode`).

Decode caches are the reference's layouts, ``{"k", "v"}`` of ``(B, L, KV,
hd)`` with RoPE'd keys: a global layer keeps ``L = cache_len`` positions,
a local (sliding-window) layer a ring of ``L = min(window, cache_len)``
in which position ``p`` sits at slot ``p % L``.  A Mamba2 mixer's cache is
``{"ssm" (B, H, P, N) float32, "conv" (B, CONV_W - 1, d_inner + 2N)}``:
the recurrent state and the last pre-convolution inputs.
:func:`attention_decode` and :func:`mamba_decode` write them in place.
Where the rules split a KV sequence over ``data`` (a batch that does not
divide the data axes: the long-context decode), a placed cache holds
each k and v as the list of its held data shards' slices, and the decode
attends them slice by slice and combines the partial softmaxes over
``data`` (:func:`_split_attend`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import HEAD_DIMS, MAX_GROUP

Params = dict[str, Any]

_MASK_VALUE = -2.0e38
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and dtype, and its value: ``fill`` (zeros
    by default) when ``scale`` is None, else a float32 Normal(0, 1) draw
    times ``scale``, cast to ``dtype``."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    scale: float | None
    fill: float = 0.0


def dense(shape: tuple[int, ...], dtype: torch.dtype,
          scale: float | None = None) -> Leaf:
    """A drawn leaf at ``scale``, 1/sqrt(fan_in) by default (the
    reference's ``_dense_init``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    return Leaf(tuple(shape), dtype,
                scale if scale is not None else 1.0 / math.sqrt(fan_in))


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"{cfg.name}: dtype {cfg.dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def norm_spec(cfg: ModelConfig, dim: int | None = None) -> Params:
    """A float32 ``scale`` of zeros (the gain is ``1 + scale``), and for
    layernorm a float32 ``bias`` of zeros, of width ``dim`` (default
    ``d_model``)."""
    zeros = Leaf((dim or cfg.d_model,), torch.float32, None)
    if cfg.norm == "rmsnorm":
        return {"scale": zeros}
    return {"scale": zeros, "bias": zeros}


def norm_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gemma-style RMSNorm, or layernorm (population variance) when ``p``
    has a ``bias``; in float32, eps 1e-6, back in ``x``'s dtype."""
    xf = x.float()
    if "bias" in p:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        centered = xf - mean
        var = torch.mean(centered * centered, dim=-1, keepdim=True)
        y = centered * torch.rsqrt(var + 1e-6)
        y = y * (1.0 + p["scale"]) + p["bias"]
    else:
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


def attention_spec(cfg: ModelConfig) -> Params:
    """Self-attention's weights; a cross-attention has the same shapes (its
    keys and values come from memory states of width d_model)."""
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    return {
        "wq": dense((cfg.d_model, cfg.num_heads, hd), dt),
        "wk": dense((cfg.d_model, cfg.num_kv_heads, hd), dt),
        "wv": dense((cfg.d_model, cfg.num_kv_heads, hd), dt),
        "wo": dense((cfg.num_heads, hd, cfg.d_model), dt),
    }


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None,
            softcap: float) -> torch.Tensor:
    """The float32 scores (B,Hkv,S,G,T) of :func:`_sdpa`, softcapped and
    masked."""
    hd = q.shape[-1]
    scores = torch.einsum("bsngh,btnh->bnsgt", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    # scores are (B,Hkv,S,G,T); the mask broadcasts as (B,1,S,1,T)
    if mask is not None:
        scores = torch.where(mask[:, None, :, None, :], scores, _MASK_VALUE)
    return scores


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, softcap: float) -> torch.Tensor:
    """q: (B,S,Hkv,G,hd), k/v: (B,T,Hkv,hd), mask: (B,S,T) bool, or None
    to attend to every key (cross-attention) -> (B,S,Hkv,G,hd) float32.  A
    nonzero ``softcap`` c maps the scaled scores s to ``tanh(s / c) * c``
    before the mask."""
    probs = torch.softmax(_scores(q, k, mask, softcap), dim=-1)
    return torch.einsum("bnsgt,btnh->bsngh", probs.to(v.dtype).float(),
                        v.float())


def _q_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int,
             window: int, softcap: float) -> torch.Tensor:
    """``_sdpa`` of the queries at positions ``start ..`` over every key,
    under the (1, qc, S) causal mask of those rows (and the window)."""
    row = torch.arange(start, start + q.shape[1], device=q.device)
    col = torch.arange(k.shape[1], device=q.device)
    mask = row[:, None] >= col[None, :]
    if window:
        mask &= row[:, None] - col[None, :] < window
    return _sdpa(q, k, v, mask[None], softcap)


def attention_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  kv_override: torch.Tensor | None = None,
                  return_kv: bool = False, partial: bool = False):
    """Full-sequence causal self-attention.  x: (B,S,D) -> (B,S,D).  A
    nonzero ``window`` also masks every key ``window`` or more positions
    behind the query (``q_pos - t_pos < window``).  With ``kv_override``,
    a memory (B,T,D) in the model dtype, it is cross-attention: keys and
    values are projected from the memory, and neither the queries nor the
    keys take RoPE nor a mask.  With ``return_kv`` also returns the
    (RoPE'd) k and v, (B,S,KV,hd) each, for the decode cache.

    With an ``attn_q_chunk`` qc that divides S and is below it, a
    self-attention never makes its (S, S) scores: the queries run in
    chunks of qc in order, each under a checkpoint with its own (qc, S)
    mask, and the chunks' outputs are concatenated, as the reference's
    scan over chunks.  The cross-attention is never chunked.

    With ``partial`` the output stays float32, uncast: one model shard's
    row-parallel partial of ``wo`` (:func:`attention_tp`)."""
    kv_in = x if kv_override is None else kv_override
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", kv_in, p["wk"])
    v = torch.einsum("btd,dnh->btnh", kv_in, p["wv"])
    if kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, positions, window, kv_override is not None)
    # float32 attention output times the weight: float32, as jnp promotes
    y = torch.einsum("bsnh,nhd->bsd", out, p["wo"].float())
    if not partial:
        y = y.to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, positions: torch.Tensor, window: int,
            cross: bool) -> torch.Tensor:
    """The attention of q (B,S,H,hd) over k and v (B,T,KV,hd), query head
    ``n`` on KV head ``n // (H / KV)``, RoPE already applied -> (B,S,H,hd)
    float32: causal (and windowed) for a self-attention, chunked by
    ``attn_q_chunk`` where it applies, unmasked for a ``cross`` one."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, hd)
    qc = cfg.attn_q_chunk
    if qc and S % qc == 0 and S > qc and not cross:
        out = torch.cat([
            checkpoint(_q_chunk, q[:, start:start + qc], k, v, start, window,
                       cfg.attn_softcap, use_reentrant=False)
            for start in range(0, S, qc)], dim=1)
    else:
        mask = None
        if not cross:
            mask = positions[:, :, None] >= positions[:, None, :]
            if window:
                mask &= positions[:, :, None] - positions[:, None, :] \
                    < window
        out = _sdpa(q, k, v, mask, cfg.attn_softcap)
    return out.reshape(B, S, H, hd)


def kv_to_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                seq_len: int, cache_len: int, window: int = 0) -> Params:
    """Full-sequence k/v (B,S,KV,hd) as a decode cache, cast to the model
    dtype.  A global layer (``window`` 0) keeps ``cache_len`` positions,
    zero-padded after ``seq_len - 1``.  A local layer keeps a ring of
    ``L = min(window, cache_len)``: the last L positions rolled by
    ``seq_len % L`` so that position p sits at slot ``p % L`` (the
    addressing of :func:`attention_decode`), or, for a prompt shorter
    than L, positions 0 .. S-1 at slots 0 .. S-1 and zeros after."""
    dt = dtype_of(cfg)
    if window:
        cap = min(window, cache_len)
        if seq_len >= cap:
            shift = seq_len % cap
            return {"k": torch.roll(k[:, -cap:], shift, dims=1).to(dt),
                    "v": torch.roll(v[:, -cap:], shift, dims=1).to(dt)}
        pad = cap - seq_len
    else:
        pad = cache_len - seq_len
        if pad < 0:
            raise ValueError(f"cache_len {cache_len} < prompt {seq_len}")
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": k.to(dt), "v": v.to(dt)}


def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int,
                    device: torch.device, window: int = 0) -> Params:
    """An empty (zero) KV cache of one attention layer in the model dtype:
    ``cache_len`` positions, or a ring of ``min(window, cache_len)`` for a
    local layer."""
    length = min(window, cache_len) if window else cache_len
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _write_rows(cache: torch.Tensor, slots: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slots[b]] = new[b]`` in place, for every row whose slot
    is in ``[0, L)``; a row at or past L is dropped, as the reference's
    ``.at[...].set(mode="drop")`` drops it (an engine slot that finished
    can reach ``max_len``), and so is a row below 0 (a slot that another
    data shard's slice of the sequence holds).  No host round trip: the
    dropped rows write back what the cache held."""
    B, L = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    keep = ((slots >= 0) & (slots < L))[:, None, None]
    slot = slots.clamp(0, L - 1)
    cache[rows, slot] = torch.where(keep, new.to(cache.dtype),
                                    cache[rows, slot])


def cross_kernel(cfg: ModelConfig) -> bool:
    """Whether the cross-attention decode of ``cfg`` runs ``flash_decode``:
    its head dim is one the kernel takes, its query heads per KV head at
    most ``MAX_GROUP``, and it has no attention softcap (the kernel's
    contract has none)."""
    G = cfg.num_heads // cfg.num_kv_heads
    return (cfg.resolved_head_dim in HEAD_DIMS and G <= MAX_GROUP
            and not cfg.attn_softcap)


def _cross_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  memory: torch.Tensor, partial: bool = False
                  ) -> torch.Tensor:
    """One-token cross-attention of x (B,1,D) over ``memory`` (B,T,D),
    whose k and v are projected anew each step, as the reference projects
    them; no RoPE, no mask.  Through ``flash_decode`` at ``pos = T - 1``
    (which masks nothing) where :func:`cross_kernel` allows, with k and v
    made contiguous (B,T,KV,hd) for its tensor map; else the reference's
    ``_sdpa`` without a mask.  With ``partial``, one model shard's float32
    partial of the row-parallel ``wo``."""
    B, T = x.shape[0], memory.shape[1]
    hd = cfg.resolved_head_dim
    KV = cfg.num_kv_heads
    G = cfg.num_heads // KV
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", memory, p["wk"])
    v = torch.einsum("btd,dnh->btnh", memory, p["wv"])
    if cross_kernel(cfg):
        out = ops.flash_decode(q.reshape(B, KV, G, hd).contiguous(),
                               k.contiguous(), v.contiguous(), T - 1)
        out = out.reshape(B, 1, cfg.num_heads, hd)
        return _out_proj(out, p["wo"], x.dtype, partial)
    out = _sdpa(q.reshape(B, 1, KV, G, hd), k, v, None, cfg.attn_softcap)
    out = out.reshape(B, 1, cfg.num_heads, hd)
    return _out_proj(out, p["wo"].float(), x.dtype, partial)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype,
              partial: bool) -> torch.Tensor:
    """The attention output (B,1,H,hd) through ``wo``, cast to ``dtype``;
    with ``partial`` one model shard's float32 partial, uncast."""
    if partial:
        return torch.einsum("bsnh,nhd->bsd", out.float(), wo.float())
    return torch.einsum("bsnh,nhd->bsd", out, wo).to(dtype)


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Params, pos: torch.Tensor, *, window: int = 0,
                     kv_override: torch.Tensor | None = None,
                     partial: bool = False, tp=None
                     ) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,D); ``pos`` a 0-d integer tensor (every
    sequence at one position, the fixed-batch loop) or a (B,) vector (one
    position a slot, the continuous-batching engine).  The new k and v are
    written into ``cache`` in place at each row's slot: its position in a
    global layer (rows at or past the cache's length are dropped), the
    position modulo the ring's length L in a local layer (``window``
    nonzero), where slot ``idx`` then holds the position ``pos - ((pos -
    idx) % L)`` and counts when that is 0 or more.  Returns ``(y (B,1,D),
    cache)``.

    The route depends on the layer and the position, never on a failure:
    a global layer (``window`` 0) of a model without an attention softcap
    at a scalar ``pos`` goes through the ``flash_decode`` kernel
    (``ops.flash_decode``), whose contract, like the TPU kernel's, has
    neither a window nor a softcap.  Its output is in q's dtype, its
    probabilities stay in float32, and the output projection runs in that
    dtype.  Every other case (a (B,) ``pos``, a local layer, a softcapped
    model) runs the reference's masked ``_sdpa``, which casts the
    probabilities to the value dtype and keeps a float32 output for the
    projection.  In float32 the two routes agree to float32 rounding; in
    bfloat16 they differ by those two roundings, about one bf16 ulp of the
    attention output.

    With ``kv_override``, a memory (B,T,D), it is the cross-attention
    decode of :func:`_cross_decode`: ``pos`` and ``cache`` are not read,
    and ``cache`` is returned unwritten.

    With ``partial`` y is one model shard's float32 partial of the
    row-parallel ``wo``, uncast (:func:`attention_decode_tp`).

    Where ``cache``'s k and v are lists, the held data shards' slices of a
    sequence split over ``data`` (``tp``, the model axis, says which),
    the new row is written by the slice that holds its slot alone, and
    the attention is :func:`_split_attend`'s, by the same route."""
    if kv_override is not None:
        return _cross_decode(p, cfg, x, kv_override, partial), cache
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
    L = _cache_len(k_cache, tp)
    slots = pos_vec % L if window else pos_vec
    _write(k_cache, slots, k_new[:, 0], tp)
    _write(v_cache, slots, v_new[:, 0], tp)
    if isinstance(k_cache, list):
        out, kernel = _split_attend(cfg, q, k_cache, v_cache, pos, window,
                                    tp)
        y = _out_proj(out, p["wo"] if kernel else p["wo"].float(), x.dtype,
                      partial)
    elif pos.dim() == 0 and not window and not cfg.attn_softcap:
        out = ops.flash_decode(q.reshape(B, KV, G, hd), k_cache, v_cache, pos)
        out = out.reshape(B, 1, cfg.num_heads, hd)
        y = _out_proj(out, p["wo"], x.dtype, partial)
    else:
        idx = torch.arange(L, device=x.device)[None, :]
        if window:
            abs_pos = posb - torch.remainder(posb - idx, L)
            valid = (abs_pos >= 0) & (abs_pos <= posb)          # (B, L)
        else:
            valid = idx <= posb                                  # (B, L)
        out = _sdpa(q.reshape(B, 1, KV, G, hd), k_cache, v_cache,
                    valid[:, None, :], cfg.attn_softcap)
        out = out.reshape(B, 1, cfg.num_heads, hd)
        y = _out_proj(out, p["wo"].float(), x.dtype, partial)
    return y, {"k": k_cache, "v": v_cache}


def _cache_len(cache: torch.Tensor | list, tp) -> int:
    """The whole sequence length of a cache leaf, or of the held data
    shards' equal slices of one split over ``data``."""
    if isinstance(cache, list):
        return cache[0].shape[1] * tp.mesh.shape["data"]
    return cache.shape[1]


def _write(cache: torch.Tensor | list, slots: torch.Tensor,
           new: torch.Tensor, tp) -> None:
    """:func:`_write_rows` into a cache leaf, or into the held data
    shards' slices of one split over ``data``: slice ``s`` holds the
    global slots ``[s * Ls, (s + 1) * Ls)`` and writes a row whose slot
    it holds, at ``slot - s * Ls``, and no other."""
    if not isinstance(cache, list):
        _write_rows(cache, slots, new)
        return
    n = cache[0].shape[1]
    for c, s in zip(cache, tp.seq_shards(), strict=True):
        _write_rows(c, slots - s * n, new)


def _split_attend(cfg: ModelConfig, q: torch.Tensor, ks: list, vs: list,
                  pos: torch.Tensor, window: int, tp
                  ) -> tuple[torch.Tensor, bool]:
    """The attention of q (B,1,H,hd) over a KV sequence of length L split
    over the D data shards: ``ks`` and ``vs`` the held shards'
    (B, L / D, KV, hd) slices, shard ``s`` holding the global slots
    ``[s * L / D, (s + 1) * L / D)``, by the route the whole cache takes
    in :func:`attention_decode`.  A global layer of a model without a
    softcap at a scalar ``pos``: each held shard's
    ``ops.flash_decode_partial`` (the kernel reads ``pos`` less the
    slice's start on the card; float32 output and log-sum-exp), combined
    over ``data`` (``tp.seq_combine``) and rounded once to q's dtype, as
    ``flash_decode`` rounds its output.  Every other case: the masked
    softmax of :func:`_split_softmax`, each slot's mask from its global
    index (the ring's ``abs_pos`` rule in a local layer).  Returns ``(out
    (B,1,H,hd), kernel)``: q's dtype through the kernel, else
    float32."""
    B, _, H, hd = q.shape
    KV = ks[0].shape[2]
    n = ks[0].shape[1]
    L = n * tp.mesh.shape["data"]
    held = tp.seq_shards()
    if pos.dim() == 0 and not window and not cfg.attn_softcap:
        qk = q.reshape(B, KV, H // KV, hd).contiguous()
        out = tp.seq_combine([ops.flash_decode_partial(qk, kc, vc, pos,
                                                       s * n)
                              for s, kc, vc in zip(held, ks, vs,
                                                   strict=True)])
        return out.reshape(B, 1, H, hd).to(q.dtype), True
    posb = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
    scores = []
    for s, kc in zip(held, ks, strict=True):
        idx = s * n + torch.arange(n, device=q.device)[None, :]
        if window:
            abs_pos = posb - torch.remainder(posb - idx, L)
            valid = (abs_pos >= 0) & (abs_pos <= posb)
        else:
            valid = idx <= posb
        scores.append(_scores(q.reshape(B, 1, KV, H // KV, hd), kc,
                              valid[:, None, :], cfg.attn_softcap))
    return _split_softmax(scores, vs, tp).reshape(B, 1, H, hd), False


def _split_softmax(scores: list, vs: list, tp) -> torch.Tensor:
    """:func:`_sdpa`'s softmax and weighted values over the held data
    shards' float32 scores (B,Hkv,S,G,T_s) (:func:`_scores`) and value
    slices, as GSPMD partitions the reference's softmax: each shard's
    largest score and its sum of ``exp(s - max)`` gathered over ``data``
    (``tp.seq_gather``) into the whole's max M and sum, in shard order;
    each probability ``exp(s - M) / sum`` cast to the value dtype, as the
    whole softmax's are, before its shard's float32 ``p @ v``; the
    shards' outputs summed in shard order (``tp.seq_sum``).  Returns
    (B,S,Hkv,G,hd) float32.  A slice whose every slot is masked weighs
    0."""
    stats = []
    for sc in scores:
        m = sc.amax(dim=-1)
        stats.append(torch.stack([m, torch.exp(sc - m[..., None]).sum(-1)]))
    every = tp.seq_gather(stats)
    top = every[:, 0].amax(dim=0)
    total = torch.zeros_like(top)
    for m, l in every:
        total.add_(l * torch.exp(m - top))
    return tp.seq_sum([torch.einsum(
        "bnsgt,btnh->bsngh", (torch.exp(sc - top[..., None])
                              / total[..., None]).to(vc.dtype).float(),
        vc.float()) for sc, vc in zip(scores, vs, strict=True)])


def mlp_spec(cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    return {
        "wi_gate": dense((cfg.d_model, cfg.d_ff), dt),
        "wi_up": dense((cfg.d_model, cfg.d_ff), dt),
        "wo": dense((cfg.d_ff, cfg.d_model), dt),
    }


def mlp_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return (h @ p["wo"]).to(x.dtype)


def moe_spec(cfg: ModelConfig) -> Params:
    """A float32 router (D, E) and the experts' gated MLPs stacked on a
    leading E axis."""
    dt = dtype_of(cfg)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense((D, E), torch.float32),
        "wi_gate": dense((E, D, F), dt),
        "wi_up": dense((E, D, F), dt),
        "wo": dense((E, F, D), dt),
    }


def expert_counts(flat_sel: torch.Tensor, experts: int) -> torch.Tensor:
    """The (E,) int64 count of each expert in ``flat_sel``: the integers
    of ``torch.bincount(flat_sel, minlength=E)``, by a scatter-add, which
    has a meta kernel (the dry run traces on meta tensors)."""
    return torch.zeros((experts,), dtype=torch.int64,
                       device=flat_sel.device).scatter_add_(
        0, flat_sel, torch.ones_like(flat_sel))


def moe_route(p: Params, cfg: ModelConfig, xt: torch.Tensor,
              logits: torch.Tensor | None = None) -> dict:
    """The reference's routing of T tokens xt (T, D): the float32 router's
    softmax (of ``logits`` (T, E) where they are given: the model axis's
    gathered router columns, :func:`moe_tp`), its ``top_k`` (``sel`` (T, K), the weights renormalised to sum
    to 1), the Switch-style load-balance ``aux`` loss, the capacity
    ``cap = max(1, int(T * K / E * capacity_factor))``, and each (token,
    choice) entry's ``slot``, its rank in its expert's queue in entry
    order (a stable argsort of the flat choices), with ``keep = slot <
    cap``: entries past an expert's capacity are dropped."""
    E, K = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    if logits is None:
        logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    weights, sel = torch.topk(probs, K, dim=-1)                 # (T, K)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    flat_sel = sel.reshape(-1)                                  # (T*K,)
    counts = expert_counts(flat_sel, E)
    frac = counts.float() / (T * K)
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    cap = max(1, int(T * K / E * cfg.moe_capacity_factor))
    order = torch.argsort(flat_sel, stable=True)
    starts = torch.cumsum(counts, 0) - counts                   # (E,)
    ranks = torch.arange(flat_sel.shape[0], device=xt.device) \
        - starts[flat_sel[order]]
    slot = torch.empty_like(flat_sel).scatter_(0, order, ranks)
    return {"weights": weights, "sel": sel, "aux": aux, "cap": cap,
            "slot": slot, "keep": slot < cap}


def moe_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k MoE FFN: returns (output (B,S,D) in x's dtype, the
    float32 aux loss).  The kept entries are scattered into an (E, cap, D)
    block (a dropped one adds zeros at (E - 1, cap - 1), as the
    reference's), each expert's gated MLP runs on its block, and each
    token gathers its kept entries' outputs and sums them by its routing
    weights in x's dtype."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(B * S, D)
    r = moe_route(p, cfg, xt)
    cap, keep, flat_sel = r["cap"], r["keep"], r["sel"].reshape(-1)
    slot = r["slot"]
    src = torch.repeat_interleave(xt, K, dim=0)                 # (T*K, D)
    expert_in = torch.zeros((E, cap, D), dtype=x.dtype, device=x.device)
    expert_in.index_put_(
        (torch.where(keep, flat_sel, E - 1),
         torch.where(keep, slot, cap - 1)),
        torch.where(keep[:, None], src, 0).to(x.dtype), accumulate=True)
    h = torch.nn.functional.silu(torch.bmm(expert_in, p["wi_gate"])) \
        * torch.bmm(expert_in, p["wi_up"])
    expert_out = torch.bmm(h, p["wo"])                          # (E, cap, D)
    gathered = expert_out[flat_sel, slot.clamp(max=cap - 1)]    # (T*K, D)
    gathered = torch.where(keep[:, None], gathered, 0)
    combined = (gathered.reshape(B * S, K, D)
                * r["weights"][..., None].to(x.dtype)).sum(dim=1)
    return combined.reshape(B, S, D).to(x.dtype), r["aux"]


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
#
# ``ps`` is the list of the model shards' trees of one module that this
# process holds, ``tp`` its ``distributed.tensor_parallel.ModelAxis``.  A
# module the rules leave whole runs on the first held shard's copy.

def attention_tp(ps: list, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, tp, *, window: int = 0,
                 kv_override: torch.Tensor | None = None,
                 return_kv: bool = False):
    """:func:`attention_fwd` split over ``model`` as the rules split its
    projections (``tp.attn``).  By heads: each held shard runs its H / T
    query heads over its KV / T KV heads on the broadcast input (and
    memory).  The rules' head_dim fallback with the query heads split:
    :func:`_attention_kv_whole`.  Every projection along head_dim:
    :func:`_attention_head_dim`.  Each way the float32 partials of the
    row-parallel ``wo`` are model-summed, then cast to x's dtype.

    With ``return_kv`` also each held shard's slice of the (RoPE'd) k and
    v, a ``(k, v)`` a shard, as the decode cache's rules hold them
    (``sharding.cache_specs``): its KV heads, its head_dim columns in the
    fallback, or, where neither divides T, the whole k and v, one pair
    for every held shard (the same tensors)."""
    q_split, kv_split = tp.attn
    if "attn" not in tp.split:
        out = attention_fwd(ps[0], cfg, x, positions, window=window,
                            kv_override=kv_override, return_kv=return_kv)
        return (out[0], [out[1]] * len(ps)) if return_kv else out
    if q_split == "head_dim" or kv_split != "heads":
        run = (_attention_head_dim if q_split == "head_dim"
               else _attention_kv_whole)
        y, (k, v) = run(ps, cfg, x, positions, tp, window, kv_override)
        if not return_kv:
            return y
        if kv_split != "head_dim":
            return y, [(k, v)] * len(ps)
        return y, list(zip(_held_chunks(k, tp), _held_chunks(v, tp)))
    local = tp.local_attention(cfg)
    xs = tp.broadcast(x)
    ms = ([None] * len(ps) if kv_override is None
          else tp.broadcast(kv_override))
    outs = [attention_fwd(p, local, xi, positions, window=window,
                          kv_override=mi, partial=True, return_kv=return_kv)
            for p, xi, mi in zip(ps, xs, ms)]
    if not return_kv:
        return tp.model_sum(outs).to(x.dtype)
    return (tp.model_sum([o[0] for o in outs]).to(x.dtype),
            [o[1] for o in outs])


def _held_chunks(x: torch.Tensor, tp, dim: int = -1) -> list:
    """Each held model shard's contiguous chunk of ``x`` along ``dim``, as
    ``sharding.place`` cuts a leaf (no gradient)."""
    chunks = x.chunk(tp.size, dim=dim)
    return [chunks[t].contiguous() for t in tp.held]


def _kv_tp(ps: list, x: torch.Tensor, name: str, tp) -> torch.Tensor:
    """The (B,T,KV,hd) projection ``name`` (``wk`` or ``wv``) of ``x``,
    whole over ``model``: each held shard's head_dim slice of every KV
    head on the broadcast ``x``, gathered along head_dim; or, where the
    rules leave the weight whole, its one projection of ``x``."""
    if tp.attn[1] is None:
        return torch.einsum("btd,dnh->btnh", x, ps[0][name])
    return tp.gather([torch.einsum("btd,dnh->btnh", xi, p[name])
                      for p, xi in zip(ps, tp.broadcast(x))], dim=-1)


def _attention_kv_whole(ps: list, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, tp, window: int,
                        kv_override: torch.Tensor | None) -> torch.Tensor:
    """The query heads split over ``model``, the KV heads not (they do
    not divide T): k and v whole over ``model`` (:func:`_kv_tp`), RoPE on
    the whole head_dim (rotate-half pairs dims i and i + hd / 2), handed
    to each held shard, which attends its H / T query heads against the
    KV heads they use (``tp.kv_heads``); the backward adds the shards'
    gradients of k and v in shard order.  Returns (y, the whole (k, v))."""
    kv_in = x if kv_override is None else kv_override
    k, v = _kv_tp(ps, kv_in, "wk", tp), _kv_tp(ps, kv_in, "wv", tp)
    if kv_override is None:
        k = rope(k, positions, cfg.rope_theta)
    parts = []
    for p, xi, ki, vi, t in zip(ps, tp.broadcast(x), tp.broadcast(k),
                                tp.broadcast(v), tp.held):
        q = torch.einsum("bsd,dnh->bsnh", xi, p["wq"])
        if kv_override is None:
            q = rope(q, positions, cfg.rope_theta)
        heads = tp.kv_heads(cfg, t).to(k.device)
        out = _attend(cfg, q, ki.index_select(2, heads),
                      vi.index_select(2, heads), positions, window,
                      kv_override is not None)
        parts.append(torch.einsum("bsnh,nhd->bsd", out, p["wo"].float()))
    return tp.model_sum(parts).to(x.dtype), (k, v)


def _attention_head_dim(ps: list, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, tp, window: int,
                        kv_override: torch.Tensor | None) -> torch.Tensor:
    """Every projection split along head_dim (the query heads do not
    divide T): the held shards' slices of q, k and v gathered along
    head_dim, RoPE on the whole head_dim, the attention run whole once,
    and each held shard's head_dim chunk of its output (``tp.chunk``,
    whose backward gathers the whole output gradient) through its rows
    of ``wo``.  Returns (y, the whole (k, v))."""
    kv_in = x if kv_override is None else kv_override
    q = tp.gather([torch.einsum("bsd,dnh->bsnh", xi, p["wq"])
                   for p, xi in zip(ps, tp.broadcast(x))], dim=-1)
    k, v = _kv_tp(ps, kv_in, "wk", tp), _kv_tp(ps, kv_in, "wv", tp)
    if kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _attend(cfg, q, k, v, positions, window, kv_override is not None)
    return tp.model_sum([
        torch.einsum("bsnh,nhd->bsd", o, p["wo"].float())
        for p, o in zip(ps, tp.chunk(out, -1))]).to(x.dtype), (k, v)


def mlp_tp(ps: list, x: torch.Tensor, tp) -> torch.Tensor:
    """:func:`mlp_fwd` with ``d_ff`` split over ``model``: column-parallel
    ``wi_gate`` and ``wi_up``, row-parallel ``wo`` in float32 partials,
    model-summed, then cast to x's dtype."""
    if "mlp" not in tp.split:
        return mlp_fwd(ps[0], x)
    parts = []
    for p, xi in zip(ps, tp.broadcast(x)):
        h = torch.nn.functional.silu(xi @ p["wi_gate"]) * (xi @ p["wi_up"])
        parts.append(h.float() @ p["wo"].float())
    return tp.model_sum(parts).to(x.dtype)


def moe_tp(ps: list, cfg: ModelConfig, x: torch.Tensor, tp
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_fwd` with the experts split over ``model``: the router's
    expert columns all-gathered in order into the full (tokens, E) logits,
    so every shard routes as the unsharded layer; each held shard
    scatters the kept entries of its E / T experts into its (E / T, cap,
    D) block and runs them; the gathered (tokens x K, D) entries, each
    nonzero on one shard alone, are model-summed exactly, and the combine
    is the unsharded one."""
    if "moe" not in tp.split:
        return moe_fwd(ps[0], cfg, x)
    B, S, D = x.shape
    K = cfg.experts_per_token
    el = cfg.num_experts // tp.size
    xs = tp.broadcast(x.reshape(B * S, D))
    logits = tp.gather([xi.float() @ p["router"] for p, xi in zip(ps, xs)],
                       dim=-1)
    r = moe_route(None, cfg, xs[0], logits=logits)
    cap, flat_sel, slot = r["cap"], r["sel"].reshape(-1), r["slot"]
    parts = []
    for p, xi, t in zip(ps, xs, tp.held):
        local = flat_sel - t * el
        mine = r["keep"] & (local >= 0) & (local < el)
        expert_in = torch.zeros((el, cap, D), dtype=x.dtype, device=x.device)
        expert_in.index_put_(
            (torch.where(mine, local, el - 1),
             torch.where(mine, slot, cap - 1)),
            torch.where(mine[:, None], torch.repeat_interleave(xi, K, dim=0),
                        0).to(x.dtype), accumulate=True)
        h = torch.nn.functional.silu(torch.bmm(expert_in, p["wi_gate"])) \
            * torch.bmm(expert_in, p["wi_up"])
        out = torch.bmm(h, p["wo"])                             # (el, cap, D)
        got = out[local.clamp(0, el - 1), slot.clamp(max=cap - 1)]
        parts.append(torch.where(mine[:, None], got, 0))
    gathered = tp.model_sum(parts)                                    # (T*K, D)
    combined = (gathered.reshape(B * S, K, D)
                * r["weights"][..., None].to(x.dtype)).sum(dim=1)
    return combined.reshape(B, S, D).to(x.dtype), r["aux"]


def attention_decode_tp(ps: list, cfg: ModelConfig, x: torch.Tensor,
                        caches: list, pos: torch.Tensor, tp, *,
                        window: int = 0) -> torch.Tensor:
    """:func:`attention_decode` split over ``model``: ``caches`` are the
    held shards' ``{"k", "v"}`` slices (``sharding.cache_specs``), each a
    tensor of its own, written in place.  By heads each held shard writes
    its KV heads' new row into its slice and runs the decode (through
    ``flash_decode`` where the unsplit decode does) on its (B, KV / T, G,
    hd) queries against its (B, L, KV / T, hd) cache; the float32
    partials of the row-parallel ``wo`` are model-summed in shard order,
    then cast.  In the rules' head_dim fallback: :func:`_decode_gathered`.
    Where the rules split the sequence over ``data`` each (data, model)
    shard holds its KV heads of its positions, and each held model
    shard's decode combines its data shards' partials
    (:func:`_split_attend`).  Returns y (B, 1, D)."""
    if "attn" not in tp.split:
        return attention_decode(ps[0], cfg, x, caches[0], pos,
                                window=window, tp=tp)[0]
    if tp.attn[1] != "heads":
        return _decode_gathered(ps, cfg, x, caches, pos, tp, window)
    local = tp.local_attention(cfg)
    return tp.model_sum([
        attention_decode(p, local, xi, c, pos, window=window,
                         partial=True, tp=tp)[0]
        for p, xi, c in zip(ps, tp.broadcast(x), caches)]).to(x.dtype)


def _decode_gathered(ps: list, cfg: ModelConfig, x: torch.Tensor,
                     caches: list, pos: torch.Tensor, tp, window: int
                     ) -> torch.Tensor:
    """The decode where the KV heads do not divide T: the new k and v
    whole over ``model`` (:func:`_kv_tp`), RoPE'd on the whole head_dim,
    each held shard writing its head_dim columns into its slice (or, with
    k and v whole, the one whole cache all held shards share); the cache's
    k and v gathered along head_dim over ``model``, and q gathered along
    the dimension its weight splits; the attention run whole (through
    ``flash_decode`` where the unsplit decode does); and each held shard's
    chunk of the output, along that dimension, through its rows of
    ``wo``, the float32 partials model-summed in shard order.  Where the
    rules split the sequence over ``data``, each held data shard's
    slices are gathered along head_dim over ``model`` and the whole
    heads attended by :func:`_split_attend`."""
    B = x.shape[0]
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    G = cfg.num_heads // KV
    qdim = 2 if tp.attn[0] == "heads" else -1
    pos_vec = pos.expand(B) if pos.dim() == 0 else pos
    posb = pos_vec[:, None]
    q = tp.gather([torch.einsum("bsd,dnh->bsnh", xi, p["wq"])
                   for p, xi in zip(ps, tp.broadcast(x))], dim=qdim)
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(_kv_tp(ps, x, "wk", tp), posb, cfg.rope_theta)[:, 0]
    v_new = _kv_tp(ps, x, "wv", tp)[:, 0]
    L = _cache_len(caches[0]["k"], tp)
    slots = pos_vec % L if window else pos_vec
    split = tp.attn[1] == "head_dim"
    for c, kn, vn in zip(caches, *((_held_chunks(k_new, tp),
                                    _held_chunks(v_new, tp)) if split
                                   else ([k_new], [v_new]))):
        _write(c["k"], slots, kn, tp)
        _write(c["v"], slots, vn, tp)

    def whole(name):
        if not split:
            return caches[0][name]
        if isinstance(caches[0][name], list):
            return [tp.gather(list(sl), dim=-1)
                    for sl in zip(*(c[name] for c in caches))]
        return tp.gather([c[name] for c in caches], dim=-1)

    k, v = whole("k"), whole("v")
    if isinstance(k, list):
        out, _ = _split_attend(cfg, q.contiguous(), k, v, pos, window, tp)
    elif pos.dim() == 0 and not window and not cfg.attn_softcap:
        out = ops.flash_decode(q.reshape(B, KV, G, hd).contiguous(), k, v,
                               pos).reshape(B, 1, cfg.num_heads, hd)
    else:
        idx = torch.arange(L, device=x.device)[None, :]
        if window:
            abs_pos = posb - torch.remainder(posb - idx, L)
            valid = (abs_pos >= 0) & (abs_pos <= posb)
        else:
            valid = idx <= posb
        out = _sdpa(q.reshape(B, 1, KV, G, hd), k, v, valid[:, None, :],
                    cfg.attn_softcap).reshape(B, 1, cfg.num_heads, hd)
    return tp.model_sum([_out_proj(o, p["wo"], x.dtype, True)
                         for p, o in zip(ps, tp.chunk(out, qdim))]
                        ).to(x.dtype)


def cross_decode_tp(ps: list, cfg: ModelConfig, x: torch.Tensor,
                    memory: torch.Tensor, tp) -> torch.Tensor:
    """The cross-attention decode of ``x`` (B, 1, D) over ``memory`` (B,
    T, D), whole over ``model``, split as :func:`attention_tp` splits it:
    by heads each held shard runs :func:`_cross_decode` on its heads (the
    kernel where the unsplit decode takes it), its float32 ``wo``
    partial model-summed; in the head_dim fallback the full-sequence
    cross-attention of :func:`attention_tp` on the one query."""
    if "attn" not in tp.split:
        return _cross_decode(ps[0], cfg, x, memory)
    if tp.attn != ("heads", "heads"):
        return attention_tp(ps, cfg, x, None, tp, kv_override=memory)
    local = tp.local_attention(cfg)
    return tp.model_sum([
        _cross_decode(p, local, xi, mi, partial=True)
        for p, xi, mi in zip(ps, tp.broadcast(x), tp.broadcast(memory))]
    ).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 / SSD mixer

CONV_W = 4  # causal short-conv width


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads H, state N) of the mixer: d_inner = expand x
    d_model in heads of ``ssm_head_dim`` (P) values."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def mamba_spec(cfg: ModelConfig) -> Params:
    """The float32 per-head ``A_log`` and ``dt_bias`` (zeros) and
    ``D_skip`` (ones); ``out_norm`` of width d_inner and ``out_proj``; and
    the input projections: the fused ``in_proj`` (D, 2 d_inner + 2N + H)
    giving z, x, B, C and dt, and the depthwise ``conv_w`` (CONV_W,
    d_inner + 2N) at scale 0.5, or, with ``mamba_split_proj``, the
    reference's one weight a stream, ``w_z`` and ``w_x`` (D, d_inner),
    ``w_B`` and ``w_C`` (D, N) and ``w_dt`` (D, H), and one conv a
    convolved stream, ``conv_x`` (CONV_W, d_inner), ``conv_B`` and
    ``conv_C`` (CONV_W, N), at scale 0.5."""
    dt = dtype_of(cfg)
    D = cfg.d_model
    d_inner, H, N = ssm_dims(cfg)
    common = {
        "A_log": Leaf((H,), torch.float32, None),
        "D_skip": Leaf((H,), torch.float32, None, fill=1.0),
        "dt_bias": Leaf((H,), torch.float32, None),
        "out_norm": norm_spec(cfg, d_inner),
        "out_proj": dense((d_inner, D), dt),
    }
    if cfg.mamba_split_proj:
        return common | {
            "w_z": dense((D, d_inner), dt),
            "w_x": dense((D, d_inner), dt),
            "w_B": dense((D, N), dt),
            "w_C": dense((D, N), dt),
            "w_dt": dense((D, H), dt),
            "conv_x": dense((CONV_W, d_inner), dt, scale=0.5),
            "conv_B": dense((CONV_W, N), dt, scale=0.5),
            "conv_C": dense((CONV_W, N), dt, scale=0.5),
        }
    return common | {
        "in_proj": dense((D, 2 * d_inner + 2 * N + H), dt),
        "conv_w": dense((CONV_W, d_inner + 2 * N), dt, scale=0.5),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` writes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (CONV_W, C); x padded by
    CONV_W - 1 zeros in front, the taps summed in order in x's dtype."""
    S = x.shape[1]
    x_pad = torch.nn.functional.pad(x, (0, 0, CONV_W - 1, 0))
    out = x_pad[:, 0:S] * w[0]
    for i in range(1, CONV_W):
        out = out + x_pad[:, i:i + S] * w[i]
    return out


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) log-decays -> (..., Q, Q): entry (i, j) the sum of x over
    (j, i], -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(xh: torch.Tensor, dt_h: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan (Mamba2, arXiv:2405.21060 Sec. 6), as the
    reference's: xh (B, S, H, P), dt_h (B, S, H) float32, a_log (H,),
    Bm and Cm (B, S, N), S a multiple of ``chunk`` -> (y (B, S, H, P)
    float32, the final state (B, H, P, N) float32).  Within a chunk the
    quadratic form, between chunks a recurrence over the chunks' end
    states from ``h0`` (zeros by default), all in float32."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    a = -torch.exp(a_log)                                   # (H,) negative
    da = (dt_h * a[None, None, :]).float()                  # (B,S,H)
    xw = xh * dt_h[..., None]                               # float32

    def c(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])
    xw_c, da_c, B_c, C_c = c(xw), c(da), c(Bm.float()), c(Cm.float())

    # intra-chunk (quadratic within the chunk)
    Lm = torch.exp(_segsum(torch.movedim(da_c, -1, 2)))     # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)      # (B,nc,Q,Q)
    y_intra = torch.einsum("bchqk,bcqk,bckhp->bcqhp", Lm, scores, xw_c)

    # chunk end-states
    cum = torch.cumsum(da_c, dim=2)                         # (B,nc,Q,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end, B_c,
                          xw_c)                             # (B,nc,H,P,N)

    # the recurrence over the chunks: h_prev[:, c] is the state at the
    # start of chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,P,N)
    final = (h_prev[:, -1] * chunk_decay[:, -1, :, None, None]
             + states[:, -1])

    # inter-chunk contribution
    decay_from_start = torch.exp(cum)                       # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", C_c, h_prev,
                           decay_from_start)
    return (y_intra + y_inter).reshape(Bsz, S, H, P), final


def _in_proj(p: Params, cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """(z, the pre-convolution xBC, dt, the conv weight over xBC) of x:
    the fused ``in_proj``'s columns and ``conv_w``, or the split
    projections' outputs and convs concatenated.  A depthwise conv is per
    channel, so the split convs over their streams are the concatenated
    conv over xBC, tap for tap."""
    d_inner, _, N = ssm_dims(cfg)
    if cfg.mamba_split_proj:
        xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
        conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
        return x @ p["w_z"], xbc, x @ p["w_dt"], conv_w
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_r = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * N,
                 zxbcdt.shape[-1] - 2 * d_inner - 2 * N], dim=-1)
    return z, xbc, dt_r, p["conv_w"]


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``out_proj(out_norm(y) * silu(z))`` in ``dtype``."""
    y = norm_fwd(p["out_norm"], y.to(dtype)) * torch.nn.functional.silu(z)
    return (y @ p["out_proj"]).to(dtype)


def mamba_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
              return_cache: bool = False):
    """The full-sequence Mamba2 mixer.  x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the decode cache after the sequence: the final
    float32 state and the last ``CONV_W - 1`` pre-convolution inputs
    (pre-silu xBC) in the model dtype.  S is padded to a multiple of
    ``ssm_chunk`` with zeros (dt 0 there: a decay of 1 and no input, so
    the state is the one after position S - 1).  A cache needs at least
    ``CONV_W - 1`` positions: a shorter prompt is refused, as the
    reference's decode cannot take its shorter conv window."""
    B, S, _ = x.shape
    d_inner, H, N = ssm_dims(cfg)
    if return_cache and S < CONV_W - 1:
        raise ValueError(f"{cfg.name}: a prompt of {S} token(s) leaves a "
                         f"conv window of {S} < {CONV_W - 1} positions; the "
                         f"Mamba2 decode cache needs {CONV_W - 1}")
    z, xbc, dt_r, conv_w = _in_proj(p, cfg, x)
    conv = torch.nn.functional.silu(_causal_conv(xbc, conv_w))
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    dt_h = _softplus(dt_r.float() + p["dt_bias"])
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    pad = (-S) % cfg.ssm_chunk
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_h = torch.nn.functional.pad(dt_h, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    y, final = ssd_chunked(xh, dt_h, p["A_log"], Bm, Cm, cfg.ssm_chunk)
    y = y[:, :S] + xh[:, :S] * p["D_skip"][None, None, :, None]
    out = _gated_out(p, y.reshape(B, S, d_inner), z, x.dtype)
    if return_cache:
        return out, {"ssm": final,
                     "conv": xbc[:, -(CONV_W - 1):].to(dtype_of(cfg))}
    return out


def mamba_tp(ps: list, cfg: ModelConfig, x: torch.Tensor, tp
             ) -> torch.Tensor:
    """:func:`mamba_fwd` under ``model``: the mixer's tree put back
    together from the held shards' (``tp.whole``: the split leaves
    gathered, whose backward hands each held shard its chunk of the
    gradient) and run once over the process's batch rows; the output is
    whole, not model-summed.  A column block of the fused ``in_proj``
    mixes the z, x, B, C and dt streams, so no shard runs its block
    alone."""
    return mamba_fwd(tp.whole(ps, mamba_spec(cfg), "mixer"), cfg, x)


def mamba_cache_dims(cfg: ModelConfig, t: int) -> dict:
    """The dimension of each mixer cache leaf that ``sharding.cache_specs``
    splits over a model axis of ``t`` (None where it stays whole): the
    state's heads, the conv window's channels."""
    d_inner, H, N = ssm_dims(cfg)
    return {"ssm": 1 if H % t == 0 else None,
            "conv": 2 if (d_inner + 2 * N) % t == 0 else None}


def mamba_prefill_tp(ps: list, cfg: ModelConfig, x: torch.Tensor, tp
                     ) -> tuple[torch.Tensor, list]:
    """:func:`mamba_tp` with the decode cache: the mixer run whole, and
    its cache cut to each held shard's slice by :func:`mamba_cache_dims`
    (a whole leaf one tensor all held shards share)."""
    p = tp.whole(ps, mamba_spec(cfg), "mixer") if "mamba" in tp.split \
        else ps[0]
    out, cache = mamba_fwd(p, cfg, x, return_cache=True)
    dims = mamba_cache_dims(cfg, tp.size)
    parts = {k: (_held_chunks(v, tp, dims[k]) if dims[k] is not None
                 else [v] * len(ps)) for k, v in cache.items()}
    return out, [{k: parts[k][i] for k in parts} for i in range(len(ps))]


def mamba_decode_tp(ps: list, cfg: ModelConfig, x: torch.Tensor,
                    caches: list, tp) -> torch.Tensor:
    """:func:`mamba_decode` under ``model``: the mixer put back together
    (:func:`mamba_tp`), the held shards' cache slices gathered whole over
    ``model`` around the step (:func:`mamba_cache_dims`), and each held
    shard's part of the updated state and window written back into its
    slice, in place.  Returns the output (B, 1, D), whole."""
    p = tp.whole(ps, mamba_spec(cfg), "mixer") if "mamba" in tp.split \
        else ps[0]
    dims = mamba_cache_dims(cfg, tp.size)
    whole = {k: (tp.gather([c[k] for c in caches], dim=d) if d is not None
                 else caches[0][k]) for k, d in dims.items()}
    out, _ = mamba_decode(p, cfg, x, whole)
    for k, d in dims.items():
        if d is not None:
            for c, part in zip(caches, _held_chunks(whole[k], tp, d)):
                c[k].copy_(part)
    return out


def init_mamba_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Params:
    """An empty (zero) mixer cache: the float32 state and the conv window
    in the model dtype."""
    d_inner, H, N = ssm_dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d_inner + 2 * N),
                            dtype=dtype_of(cfg), device=device),
    }


def mamba_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params
                 ) -> tuple[torch.Tensor, Params]:
    """The one-token recurrent update.  x: (B, 1, D) -> ((B, 1, D),
    cache): the conv window takes the new pre-convolution input and drops
    its oldest, and the state decays by ``exp(dt * a)`` and takes ``dt B
    x``, in float32.  Both are written into ``cache``'s tensors in place
    (views into a stacked cache write through)."""
    B = x.shape[0]
    d_inner, H, N = ssm_dims(cfg)
    z, xbc, dt_r, conv_w = _in_proj(p, cfg, x[:, 0])         # xbc (B, C)
    conv_hist = torch.cat([cache["conv"],
                           xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bwc,wc->bc", conv_hist, conv_w)
    conv = torch.nn.functional.silu(conv)
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    dt_h = _softplus(dt_r.float() + p["dt_bias"])            # (B, H)
    decay = torch.exp(dt_h * -torch.exp(p["A_log"])[None, :])
    xh = xs.reshape(B, H, cfg.ssm_head_dim).float()
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt_h, Bm.float(), xh)
    h = cache["ssm"] * decay[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * p["D_skip"][None, :, None]
    out = _gated_out(p, y.reshape(B, d_inner), z, x.dtype)[:, None, :]
    cache["ssm"].copy_(h)
    cache["conv"].copy_(conv_hist[:, 1:])
    return out, cache
