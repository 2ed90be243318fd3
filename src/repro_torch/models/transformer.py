"""The transformer: embedding -> prefix layers -> stacked blocks -> norm
-> logits, its language-model loss, serving's prefill and one-token decode
against a KV cache, and the audio encoder that makes a decoder's memory.

Counterpart of ``repro.models.transformer`` for every architecture of the
reference: the attention-family ones (granite-8b, gemma2-27b, gemma3-12b,
starcoder2-3b, phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b), the Mamba2 ones
(mamba2-780m, zamba2-2.7b) and the two over a memory
(llama-3.2-vision-11b, seamless-m4t-medium): the layer kinds ``global``,
``local`` (sliding-window attention), ``moe`` and ``local_moe`` (the
top-k MoE FFN in place of the MLP), ``cross`` (self-attention, then
cross-attention over the memory, then the MLP), ``mamba`` (the
Mamba2/SSD mixer alone) and ``mamba_attn`` (the mixer, then zamba2's
shared attention: one set of attention weights,
``params["shared_attn"]["attn"]``, applied in every such layer and not
stacked, so that autograd sums its gradient over the layers), un-scanned
``prefix_layers``, the attention and logit softcaps, RMSNorm and
layernorm, and tied embeddings (no ``lm_head``: the embedding is scaled
by ``sqrt(d_model)`` on the way in and its transpose is the head).

The memory of a ``cross`` layer is (B, T, d_model) in the model dtype:
stub image embeddings (llama-3.2-vision-11b) or the output of
:func:`encode_audio` (seamless-m4t-medium), whose ``encoder`` is a stack
of ``global`` layers (causal, with RoPE, as the reference computes it)
and ``enc_norm``.  Without a memory a ``cross`` layer's ``xattn`` runs as
a second causal self-attention, as the reference's does (its serving
engine passes none): over the layer's input in prefill, and in decode
over the self-attention's cache as it stood before the step with the
``xattn``'s own key and value at ``pos``, on a copy, so that the cache is
not written twice.

Parameter names, the stacked ``blocks`` (a leading ``num_repeats`` axis,
one ``l{i}`` entry per position of the block pattern), the ``prefix``
list and the arithmetic are the reference's.  The reference scans the
repeat axis with ``lax.scan``; here it is a Python loop over that axis,
and autograd gives each stacked leaf its stacked gradient.

The decode cache is the reference's tree, ``{"pos", "prefix": [{"attn":
{"k", "v"}}, ...], "blocks": {"l{i}": {"attn": {"k", "v"}, "ssm": {"ssm",
"conv"}}}}`` (an attention layer's ``attn``, a mixer's ``ssm``, both in a
``mamba_attn`` layer) with each block leaf stacked to ``(num_repeats, B,
...)``: k and v ``(num_repeats, B, L, KV, hd)`` (L the cache length, or
the ring of a local layer), the mixer's state ``(num_repeats, B, H, P,
N)`` in float32 and its conv window ``(num_repeats, B, CONV_W - 1, C)``.
``cache["pos"]`` is an int32 tensor on the cache's device: a scalar after
:func:`prefill`, ``pos + 1`` after each :func:`decode_step`, or the
engine's (B,) vector of slot positions.  ``cache["memory"]``, when the
prefill or :func:`init_cache` was given one, is the cross layers' memory
(B, T, d_model), which each decode step reads and never writes; a
``cross`` layer caches its self-attention's k and v alone.
:func:`decode_step` writes the new keys and values, states and conv
windows into the cache in place (a functional update would copy the
whole cache every step) and returns a new top-level dict that shares
them.

The reference's training-memory variants run as the reference runs
them: ``attn_q_chunk`` (queries in chunks, each under a checkpoint; see
``layers.attention_fwd``), ``loss_seq_chunk`` (the head and the
cross-entropy over chunks of the sequence, each under a checkpoint; see
:func:`lm_loss`), ``remat_blocks`` (each repeat of the block pattern under
a checkpoint) and ``mamba_split_proj`` (see ``layers.mamba_spec``).  A
checkpoint here is ``torch.utils.checkpoint.checkpoint`` without
re-entry, the counterpart of ``jax.checkpoint``: the forward keeps the
segment's inputs alone and the backward runs the segment again.
:func:`check_supported` refuses a layer kind that does not exist.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import fsdp
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L

Params = dict[str, Any]

KINDS = ("global", "local", "moe", "local_moe", "cross", "mamba",
         "mamba_attn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer kind of ``cfg`` that is
    not one of ``KINDS``, and ``ValueError`` for a dtype the port does not
    take.  Every other model the port runs, it also trains (its gradient
    is autograd's through the forward)."""
    kinds = (set(cfg.block_pattern) | set(cfg.prefix_layers)) - set(KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: not ported: layer kinds {sorted(kinds)}")
    L.dtype_of(cfg)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind in ("local", "local_moe") else 0


def _is_moe(kind: str) -> bool:
    return kind in ("moe", "local_moe")


def _is_mamba(kind: str) -> bool:
    return kind in ("mamba", "mamba_attn")


def _layer_spec(cfg: ModelConfig, kind: str) -> Params:
    """Attention and an MLP (``global``, ``local``) or the MoE FFN
    (``moe``, ``local_moe``), each after a norm, with the cross-attention
    ``xattn`` after its norm ``lnx`` between them (``cross``); or the
    Mamba2 mixer after a norm (``mamba``), and the norm of the shared
    attention after it (``mamba_attn``; its attention weights are the
    model's ``shared_attn``)."""
    if _is_mamba(kind):
        spec = {"ln1": L.norm_spec(cfg), "mixer": L.mamba_spec(cfg)}
        if kind == "mamba_attn":
            spec["ln_sh"] = L.norm_spec(cfg)
        return spec
    ffn = ("moe", L.moe_spec(cfg)) if _is_moe(kind) else (
        "mlp", L.mlp_spec(cfg))
    spec = {"ln1": L.norm_spec(cfg), "attn": L.attention_spec(cfg)}
    if kind == "cross":
        spec |= {"lnx": L.norm_spec(cfg), "xattn": L.attention_spec(cfg)}
    return spec | {"ln2": L.norm_spec(cfg), ffn[0]: ffn[1]}


def _sub(p: Any, key: str, tp) -> Any:
    """``p[key]``, or under a model axis ``tp`` (``p`` the held shards'
    trees) the list of each shard's."""
    return p[key] if tp is None else [q[key] for q in p]


def _one(p: Any, tp) -> Any:
    """``p``, or under a model axis the first held shard's tree: where a
    leaf is whole over ``model`` (norms), every shard holds it."""
    return p if tp is None else p[0]


def _attention(p: Any, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, tp, **kw) -> torch.Tensor:
    if tp is None:
        return L.attention_fwd(p, cfg, x, positions, **kw)
    return L.attention_tp(p, cfg, x, positions, tp, **kw)


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, tp=None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's FFN on ``norm(x)``: (output, the MoE's aux or None)."""
    h = L.norm_fwd(_one(p, tp)["ln2"], x)
    if "moe" in _one(p, tp):
        if tp is None:
            return L.moe_fwd(p["moe"], cfg, h)
        return L.moe_tp(_sub(p, "moe", tp), cfg, h, tp)
    if tp is None:
        return L.mlp_fwd(p["mlp"], h), None
    return L.mlp_tp(_sub(p, "mlp", tp), h, tp), None


def _layer_fwd(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
               positions: torch.Tensor, aux: torch.Tensor,
               shared: Params | None = None,
               memory: torch.Tensor | None = None, tp=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's forward; under a model axis ``tp`` ``p`` (and
    ``shared``) is the held shards' trees of the layer (and of the shared
    attention)."""
    norms = _one(p, tp)
    if _is_mamba(kind):
        h = L.norm_fwd(norms["ln1"], x)
        x = x + (L.mamba_fwd(p["mixer"], cfg, h) if tp is None
                 else L.mamba_tp(_sub(p, "mixer", tp), cfg, h, tp))
        if kind == "mamba_attn":
            x = x + _attention(_sub(shared, "attn", tp), cfg,
                               L.norm_fwd(norms["ln_sh"], x), positions, tp)
        return x, aux
    x = x + _attention(_sub(p, "attn", tp), cfg, L.norm_fwd(norms["ln1"], x),
                       positions, tp, window=_window(cfg, kind))
    if kind == "cross":
        x = x + _attention(_sub(p, "xattn", tp), cfg,
                           L.norm_fwd(norms["lnx"], x), positions, tp,
                           kv_override=memory)
    h, a = _ffn(p, cfg, x, tp)
    return x + h, aux if a is None else aux + a


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 device: torch.device) -> Params:
    cache = {}
    if _is_mamba(kind):
        cache["ssm"] = L.init_mamba_cache(cfg, batch, device)
    if kind != "mamba":
        cache["attn"] = L.init_attn_cache(cfg, batch, cache_len, device,
                                          _window(cfg, kind))
    return cache


def _layer_prefill(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                   positions: torch.Tensor, seq_len: int, cache_len: int,
                   shared: Params | None = None,
                   memory: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, Params]:
    window = _window(cfg, kind)
    cache: Params = {}
    if _is_mamba(kind):
        h, cache["ssm"] = L.mamba_fwd(p["mixer"], cfg,
                                      L.norm_fwd(p["ln1"], x),
                                      return_cache=True)
        x = x + h
        if kind == "mamba":
            return x, cache
        attn, norm = shared["attn"], p["ln_sh"]
    else:
        attn, norm = p["attn"], p["ln1"]
    h, (k, v) = L.attention_fwd(attn, cfg, L.norm_fwd(norm, x), positions,
                                window=window, return_kv=True)
    cache["attn"] = L.kv_to_cache(cfg, k, v, seq_len, cache_len, window)
    x = x + h
    if _is_mamba(kind):
        return x, cache
    if kind == "cross":
        x = x + L.attention_fwd(p["xattn"], cfg, L.norm_fwd(p["lnx"], x),
                                positions, kv_override=memory)
    return x + _ffn(p, cfg, x)[0], cache


def _xattn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor,
                  memory: torch.Tensor | None) -> torch.Tensor:
    """A ``cross`` layer's ``xattn`` in decode: over ``memory``, or,
    without one, as the reference runs it: a causal self-attention over
    the layer's self-attention cache as it stood before this step with
    its own k and v at ``pos``, a write the reference discards.  The
    self-attention has written its row at each slot in place, and the
    copy's rows at those slots take the ``xattn``'s, so the copy is that
    cache, and the layer's own is written once."""
    if memory is not None:
        return L.attention_decode(p["xattn"], cfg, x, cache, pos,
                                  kv_override=memory)[0]
    prior = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    return L.attention_decode(p["xattn"], cfg, x, prior, pos)[0]


def _layer_decode(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor,
                  shared: Params | None = None,
                  memory: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's decode step, its cache written in place; returns the
    layer's output."""
    if _is_mamba(kind):
        h, _ = L.mamba_decode(p["mixer"], cfg, L.norm_fwd(p["ln1"], x),
                              cache["ssm"])
        x = x + h
        if kind == "mamba":
            return x
        h, _ = L.attention_decode(shared["attn"], cfg,
                                  L.norm_fwd(p["ln_sh"], x), cache["attn"],
                                  pos)
        return x + h
    h, _ = L.attention_decode(p["attn"], cfg, L.norm_fwd(p["ln1"], x),
                              cache["attn"], pos, window=_window(cfg, kind))
    x = x + h
    if kind == "cross":
        x = x + _xattn_decode(p, cfg, L.norm_fwd(p["lnx"], x),
                              cache["attn"], pos, memory)
    return x + _ffn(p, cfg, x)[0]


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree: Any) -> list:
    """The leaves of a tree in its insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _materialize(spec: Any, gen: torch.Generator, device: torch.device,
                 repeats: int | None = None) -> Any:
    """The tensors of a tree of ``layers.Leaf`` on ``device``, each with a
    leading ``repeats`` axis when that is given.  Each leaf is allocated
    once; for each repeat in turn, each drawn leaf in tree order takes a
    float32 Normal(0, 1) draw on the generator's device, times its scale,
    cast into its slot.  So the values are those of drawing every repeat's
    tree one after another and stacking them, and the peak is the tensors
    plus one leaf's float32 draw."""
    lead = () if repeats is None else (repeats,)
    out = _map(spec, lambda s: torch.empty(
        (*lead, *s.shape), dtype=s.dtype, device=device)
        if s.scale is not None else
        torch.full((*lead, *s.shape), s.fill, dtype=s.dtype, device=device))
    drawn = [(s, t) for s, t in zip(_leaves(spec), _leaves(out))
             if s.scale is not None]
    for r in range(1 if repeats is None else repeats):
        for s, t in drawn:
            draw = torch.randn(s.shape, generator=gen, device=gen.device)
            (t if repeats is None else t[r]).copy_(draw.mul_(s.scale))
            del draw
    return out


def model_spec(cfg: ModelConfig) -> tuple[Params, Params]:
    """The ``layers.Leaf`` trees of :func:`init_model`: the top-level
    leaves (``embed``, ``final_norm``, ``lm_head`` unless the embeddings
    are tied, the ``prefix`` layers, zamba2's ``shared_attn`` and the audio
    ``encoder``, a ``global`` layer's leaves each stacked to a leading
    ``encoder_layers`` axis and drawn whole, and its ``enc_norm``, when the
    config has them) and one repeat of ``blocks``."""
    check_supported(cfg)
    dt = L.dtype_of(cfg)
    top: Params = {
        "embed": L.dense((cfg.vocab_size, cfg.d_model), dt, scale=0.02),
        "final_norm": L.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        top["lm_head"] = L.dense((cfg.d_model, cfg.vocab_size), dt)
    if "mamba_attn" in (*cfg.prefix_layers, *cfg.block_pattern):
        top["shared_attn"] = {"attn": L.attention_spec(cfg)}
    if cfg.prefix_layers:
        top["prefix"] = [_layer_spec(cfg, kind) for kind in cfg.prefix_layers]
    if cfg.encoder_layers:
        top["encoder"] = _map(_layer_spec(cfg, "global"), lambda s:
                              dataclasses.replace(
                                  s, shape=(cfg.encoder_layers, *s.shape)))
        top["enc_norm"] = L.norm_spec(cfg)
    block = {f"l{i}": _layer_spec(cfg, kind)
             for i, kind in enumerate(cfg.block_pattern)}
    return top, block


def param_shapes(cfg: ModelConfig) -> Params:
    """The tree of :func:`init_model` as meta tensors: every leaf's shape
    (``blocks`` stacked over ``num_repeats``) and dtype, nothing
    allocated; what the sharding rules read at full size."""
    top, block = model_spec(cfg)
    meta = torch.device("meta")
    shapes = _map(top, lambda s: torch.empty(s.shape, dtype=s.dtype,
                                             device=meta))
    shapes["blocks"] = _map(block, lambda s: torch.empty(
        (cfg.num_repeats, *s.shape), dtype=s.dtype, device=meta))
    return shapes


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device: str | torch.device = "cuda") -> Params:
    """Fresh parameters: ``embed`` (V, D) at scale 0.02, ``final_norm``,
    ``lm_head`` (D, V) unless the embeddings are tied, the shared
    attention of ``mamba_attn`` layers, the ``prefix`` layers (a list,
    when the config has any), the audio ``encoder`` stacked over
    ``encoder_layers`` and its ``enc_norm``, and ``blocks`` stacked over
    ``num_repeats``.  Drawn on the
    generator's device in a fixed order (so one seed gives the same
    parameters wherever they end up) into tensors on ``device``, each
    allocated once at its full (stacked) shape."""
    top, block = model_spec(cfg)
    dev = resolve_device(device)
    params = _materialize(top, generator, dev)
    params["blocks"] = _materialize(block, generator, dev, cfg.num_repeats)
    return params


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor, tp=None
           ) -> torch.Tensor:
    """The embedding rows, times ``sqrt(d_model)`` in the embedding's
    dtype when the embeddings are tied.  Under a model axis that splits
    the vocabulary, each held shard looks up the tokens in its rows, zero
    for a token outside them, and the shards' rows are model-summed: one
    is nonzero, so the sum is exact."""
    if tp is None or "vocab" not in tp.split:
        x = _one(params, tp)["embed"][tokens.long()]
    else:
        tok, parts = tokens.long(), []
        for p, t in zip(params, tp.held):
            n = p["embed"].shape[0]
            local = tok - t * n
            mine = (local >= 0) & (local < n)
            parts.append(torch.where(mine[..., None],
                                     p["embed"][local.clamp(0, n - 1)], 0))
        x = tp.model_sum(parts)
    if cfg.tie_embeddings:
        x = x * cfg.d_model ** 0.5
    return x.to(L.dtype_of(cfg))


def _head(params: Params, cfg: ModelConfig, tp=None) -> Any:
    """The head (D, V): ``lm_head``, or ``embed``'s transpose when the
    embeddings are tied; under a model axis the held shards' heads."""
    if tp is not None:
        return [_head(p, cfg) for p in params]
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            head: torch.Tensor | None = None) -> torch.Tensor:
    """The head in float32: (B, S, D) -> (B, S, V) through ``lm_head``, or
    ``embed``'s transpose when the embeddings are tied; softcapped by
    ``tanh(l / c) * c`` when the config has a ``logit_softcap`` c."""
    head = _head(params, cfg) if head is None else head
    logits = torch.einsum("bsd,dv->bsv", x.float(), head.float())
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _block(tree: Params, r: int) -> Params:
    return _map(tree, lambda t: t[r])


def _blocks(tree: Any, r: int, tp) -> Any:
    """Repeat ``r`` of a stacked tree, or of each held shard's."""
    return _block(tree, r) if tp is None else [_block(t, r) for t in tree]


def encode_audio(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """The audio encoder over stub frame embeddings: frames (B, T, D) ->
    memory (B, T, D) in the model dtype.  The frames are cast to the model
    dtype and run through the ``encoder``'s ``global`` layers (causal,
    with RoPE at positions 0 .. T - 1, as the reference computes them),
    then ``enc_norm``; under a model axis ``tp`` ``params`` are the held
    shards' trees."""
    check_supported(cfg)
    B, T, _ = frames.shape
    positions = torch.arange(T, device=frames.device).expand(B, T)
    x = frames.to(L.dtype_of(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=frames.device)
    encoder = _sub(params, "encoder", tp)
    for r in range(cfg.encoder_layers):
        x, _ = _layer_fwd(_blocks(encoder, r, tp), cfg, "global", x,
                          positions, aux, tp=tp)
    return L.norm_fwd(_one(params, tp)["enc_norm"], x)


def _repeat(block: Params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, aux: torch.Tensor,
            shared: Params | None, memory: torch.Tensor | None, tp=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One repeat of the block pattern: the reference's scan body."""
    for i, kind in enumerate(cfg.block_pattern):
        x, aux = _layer_fwd(_sub(block, f"l{i}", tp), cfg, kind, x,
                            positions, aux, shared, memory, tp)
    return x, aux


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   memory: torch.Tensor | None = None, tp=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int, ``memory`` (B, T, D) for the cross layers ->
    (the final norm's output (B, S, D) in the model dtype, aux): the
    forward up to the head, as the reference's ``forward_hidden``.  With
    ``remat_blocks`` each repeat of the block pattern runs under a
    checkpoint (whose backward issues the model axis's collectives
    again); the prefix layers do not.  Under a model axis ``tp``
    (``distributed.tensor_parallel.ModelAxis``) ``params`` is the list of
    the held model shards' trees (``sharding.place``), and the output is
    whole over ``model``.  FSDP-held params (``distributed.fsdp.Top``,
    the sharded fused step's) gather each top-level module on its first
    use and each repeat of ``blocks`` inside a checkpoint of the repeat,
    whatever ``remat_blocks`` says; a whole tree runs as above."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    shared = (_sub(params, "shared_attn", tp)
              if "shared_attn" in _one(params, tp) else None)
    for i, kind in enumerate(cfg.prefix_layers):
        layer = (params["prefix"][i] if tp is None
                 else [p["prefix"][i] for p in params])
        x, aux = _layer_fwd(layer, cfg, kind, x, positions, aux, shared,
                            memory, tp)
    blocks = _sub(params, "blocks", tp)
    for r in range(cfg.num_repeats):
        rest = (cfg, x, positions, aux, shared, memory, tp)
        if fsdp.held(blocks):
            x, aux = checkpoint(_held_repeat, blocks, r, *rest,
                                use_reentrant=False)
            continue
        args = (_blocks(blocks, r, tp), *rest)
        x, aux = (checkpoint(_repeat, *args, use_reentrant=False)
                  if cfg.remat_blocks else _repeat(*args))
    return L.norm_fwd(_one(params, tp)["final_norm"], x), aux


def _held_repeat(blocks: Any, r: int, *rest) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """:func:`_repeat` on repeat ``r`` of FSDP-held ``blocks``, gathered
    over ``data`` here, inside the repeat's checkpoint, so that the
    backward gathers them again."""
    return _repeat(fsdp.repeat(blocks, r), *rest)


def forward_aux(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                memory: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int, ``memory`` (B, T, D) for the cross layers ->
    (logits (B, S, V) float32, aux), ``aux`` the float32 sum of the MoE
    layers' load-balance losses (0.0 without any), as the reference's
    ``forward`` returns them."""
    x, aux = forward_hidden(params, cfg, tokens, memory)
    return _logits(params, cfg, x), aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: (B, S) int, ``memory`` (B, T, D) for the cross layers ->
    logits (B, S, V) float32 (see :func:`forward_aux` for the MoE's aux
    loss)."""
    return forward_aux(params, cfg, tokens, memory)[0]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: torch.Tensor | None = None,
            cache_len: int | None = None, tp=None
            ) -> tuple[torch.Tensor, Params]:
    """Score the prompt and build the decode cache.  tokens: (B, S) int,
    ``memory`` (B, T, D) for the cross layers -> (last-position logits (B,
    V) float32, a cache of ``cache_len`` positions (default S; a local
    layer keeps its ring, a Mamba2 mixer its state and conv window) ready
    for :func:`decode_step` at ``pos = S``, holding ``memory`` when one
    was given).

    Under a model axis ``tp`` ``params`` are the held model shards' trees
    (or their FSDP views, ``distributed.fsdp.Top``) and the cache is a
    list, one tree a held shard, each leaf that shard's slice by
    ``sharding.cache_specs`` (:func:`_prefill_tp`)."""
    check_supported(cfg)
    if tp is not None:
        return _prefill_tp(params, cfg, tokens, memory, cache_len, tp)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cache: Params = {"pos": torch.full((), S, dtype=torch.int32,
                                       device=tokens.device)}
    if memory is not None:
        cache["memory"] = memory
    shared = params.get("shared_attn")
    if cfg.prefix_layers:
        cache["prefix"] = []
        for i, kind in enumerate(cfg.prefix_layers):
            x, c = _layer_prefill(params["prefix"][i], cfg, kind, x,
                                  positions, S, cache_len, shared, memory)
            cache["prefix"].append(c)
    blocks = []
    for r in range(cfg.num_repeats):
        block = _block(params["blocks"], r)
        block_c = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, block_c[f"l{i}"] = _layer_prefill(block[f"l{i}"], cfg, kind,
                                                 x, positions, S, cache_len,
                                                 shared, memory)
        blocks.append(block_c)
    cache["blocks"] = _stack(blocks)
    x = L.norm_fwd(params["final_norm"], x[:, -1:, :])
    return _logits(params, cfg, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: str | torch.device = "cuda",
               memory: torch.Tensor | None = None) -> Params:
    """An empty cache at ``pos = 0``, each block leaf allocated once at its
    stacked ``(num_repeats, ...)`` shape, holding ``memory`` when one is
    given."""
    dev = resolve_device(device)
    cache = _map(cache_shapes(cfg, batch, cache_len), lambda t: torch.zeros(
        t.shape, dtype=t.dtype, device=dev))
    if memory is not None:
        cache["memory"] = memory
    return cache


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int,
                 memory_len: int = 0) -> Params:
    """The tree of :func:`init_cache` as meta tensors (with a ``memory`` of
    ``memory_len`` positions when that is nonzero): the shapes the cache
    rules read, nothing allocated."""
    check_supported(cfg)
    meta = torch.device("meta")
    cache: Params = {"pos": torch.empty((), dtype=torch.int32, device=meta)}
    if cfg.prefix_layers:
        cache["prefix"] = [_layer_cache(cfg, kind, batch, cache_len, meta)
                           for kind in cfg.prefix_layers]
    cache["blocks"] = {
        f"l{i}": _map(_layer_cache(cfg, kind, batch, cache_len, meta),
                      lambda t: torch.empty((cfg.num_repeats, *t.shape),
                                            dtype=t.dtype, device=meta))
        for i, kind in enumerate(cfg.block_pattern)}
    if memory_len:
        cache["memory"] = torch.empty((batch, memory_len, cfg.d_model),
                                      dtype=L.dtype_of(cfg), device=meta)
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, tp=None) -> tuple[torch.Tensor, Params]:
    """token: (B, 1) int -> (logits (B, 1, V) float32, the cache at
    ``pos + 1``).  The cache's k and v, states and conv windows are
    written in place (each repeat's are views into the stacked leaves); a
    global layer's attention, a cross layer's self-attention and zamba2's
    shared attention go through ``flash_decode`` when ``cache["pos"]`` is
    a scalar and the model has no attention softcap, every other through
    the masked attention (see ``layers.attention_decode``).  A cross
    layer's cross-attention over ``cache["memory"]`` goes through
    ``flash_decode`` wherever ``layers.cross_kernel`` allows, at a scalar
    or a (B,) position.

    Under a model axis ``tp`` ``params`` are the held model shards' trees
    (or FSDP views) and ``cache`` the list of the held shards' cache
    trees of :func:`prefill` (:func:`_decode_tp`)."""
    check_supported(cfg)
    if tp is not None:
        return _decode_tp(params, cfg, token, cache, tp)
    pos = cache["pos"]
    memory = cache.get("memory")
    x = _embed(params, cfg, token)
    shared = params.get("shared_attn")
    for i, kind in enumerate(cfg.prefix_layers):
        x = _layer_decode(params["prefix"][i], cfg, kind, x,
                          cache["prefix"][i], pos, shared, memory)
    for r in range(cfg.num_repeats):
        block = _block(params["blocks"], r)
        block_c = _block(cache["blocks"], r)
        for i, kind in enumerate(cfg.block_pattern):
            x = _layer_decode(block[f"l{i}"], cfg, kind, x,
                              block_c[f"l{i}"], pos, shared, memory)
    x = L.norm_fwd(params["final_norm"], x)
    return _logits(params, cfg, x), {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# serving under a model axis: each held model shard's slice of the cache
#
# These walks give the unplaced walks' bits at a 1 x 1 mesh, but they
# are not the one-card path: on an H100 their host work made a granite-8b
# decode step 1.19x as long (chip_smoke.py phase 23 (e)), and a cross
# layer's decode without memory is refused here.  ROADMAP.md says what
# retires one of the two.

def _shared(params: Any, tp) -> Any:
    """zamba2's shared attention (the held shards' trees of it under a
    model axis), or None."""
    if "shared_attn" not in _one(params, tp):
        return None
    return _sub(params, "shared_attn", tp)


def _repeat_of(blocks: Any, r: int, tp) -> Any:
    """Repeat ``r`` of the held shards' ``blocks``: gathered over
    ``data`` where they are FSDP-held (``distributed.fsdp.repeat``)."""
    return fsdp.repeat(blocks, r) if fsdp.held(blocks) \
        else _blocks(blocks, r, tp)


def _logits_tp(params: Any, cfg: ModelConfig, x: torch.Tensor, tp
               ) -> torch.Tensor:
    """The float32 logits whole over ``model``: each held shard's
    (softcapped) columns of the vocab-parallel head, gathered over
    ``model`` in shard order; or the one head the rules leave whole."""
    heads = _head(params, cfg, tp)
    if "vocab" not in tp.split:
        return _logits(None, cfg, x, heads[0])
    return tp.gather([_logits(None, cfg, xi, w)
                      for xi, w in zip(tp.broadcast(x), heads)], dim=-1)


def _share_stack(per_repeat: list) -> list:
    """Each held shard's stacked tree from ``per_repeat`` (a list over
    the repeats of the held shards' trees): a leaf that is one tensor for
    every held shard at every repeat (whole over ``model``) is stacked
    once and shared."""
    first = per_repeat[0][0]
    if isinstance(first, dict):
        subs = {k: _share_stack([[t[k] for t in row] for row in per_repeat])
                for k in first}
        return [{k: subs[k][i] for k in first}
                for i in range(len(per_repeat[0]))]
    out = []
    for i in range(len(per_repeat[0])):
        if i and all(row[i] is row[0] for row in per_repeat):
            out.append(out[0])
        else:
            out.append(torch.stack([row[i] for row in per_repeat]))
    return out


def _layer_prefill_tp(p: list, cfg: ModelConfig, kind: str, x: torch.Tensor,
                      positions: torch.Tensor, seq_len: int, cache_len: int,
                      shared: list | None, memory: torch.Tensor | None, tp
                      ) -> tuple[torch.Tensor, list]:
    """:func:`_layer_prefill` over the held shards' trees ``p``: the
    layer's forward of :func:`_layer_fwd` under ``tp``, and each held
    shard's slice of its cache (a whole leaf one tensor they share)."""
    window = _window(cfg, kind)
    norms = _one(p, tp)
    caches: list = [{} for _ in tp.held]
    if _is_mamba(kind):
        h, mc = L.mamba_prefill_tp(_sub(p, "mixer", tp), cfg,
                                   L.norm_fwd(norms["ln1"], x), tp)
        x = x + h
        for c, m in zip(caches, mc):
            c["ssm"] = m
        if kind == "mamba":
            return x, caches
        attn, norm = _sub(shared, "attn", tp), norms["ln_sh"]
    else:
        attn, norm = _sub(p, "attn", tp), norms["ln1"]
    h, kvs = L.attention_tp(attn, cfg, L.norm_fwd(norm, x), positions, tp,
                            window=window, return_kv=True)
    made: dict = {}
    for c, (k, v) in zip(caches, kvs):
        if id(k) not in made:
            made[id(k)] = L.kv_to_cache(cfg, k, v, seq_len, cache_len,
                                        window)
        c["attn"] = made[id(k)]
    x = x + h
    if _is_mamba(kind):
        return x, caches
    if kind == "cross":
        x = x + L.attention_tp(_sub(p, "xattn", tp), cfg,
                               L.norm_fwd(norms["lnx"], x), positions, tp,
                               kv_override=memory)
    return x + _ffn(p, cfg, x, tp)[0], caches


def _prefill_tp(params: Any, cfg: ModelConfig, tokens: torch.Tensor,
                memory: torch.Tensor | None, cache_len: int | None, tp
                ) -> tuple[torch.Tensor, list]:
    """:func:`prefill` under the model axis ``tp``: training's forward
    split over ``model`` (:func:`forward_hidden`), each layer also giving
    each held shard's slice of its cache; the last position's logits
    gathered whole over ``model``.  Returns (logits (B, V), the held
    shards' cache trees, ``pos`` and ``memory`` shared by them)."""
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens, tp)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    top: Params = {"pos": torch.full((), S, dtype=torch.int32,
                                     device=tokens.device)}
    if memory is not None:
        top["memory"] = memory
    caches = [dict(top) for _ in tp.held]
    shared = _shared(params, tp)
    for i, kind in enumerate(cfg.prefix_layers):
        layer = [q["prefix"][i] for q in params]
        x, cs = _layer_prefill_tp(layer, cfg, kind, x, positions, S,
                                  cache_len, shared, memory, tp)
        for c, lc in zip(caches, cs):
            c.setdefault("prefix", []).append(lc)
    blocks = _sub(params, "blocks", tp)
    per_repeat = []
    for r in range(cfg.num_repeats):
        block = _repeat_of(blocks, r, tp)
        row: list = [{} for _ in tp.held]
        for i, kind in enumerate(cfg.block_pattern):
            x, cs = _layer_prefill_tp(_sub(block, f"l{i}", tp), cfg, kind,
                                      x, positions, S, cache_len, shared,
                                      memory, tp)
            for rc, lc in zip(row, cs):
                rc[f"l{i}"] = lc
        per_repeat.append(row)
        del block
    for c, stacked in zip(caches, _share_stack(per_repeat)):
        c["blocks"] = stacked
    x = L.norm_fwd(_one(params, tp)["final_norm"], x[:, -1:, :])
    return _logits_tp(params, cfg, x, tp)[:, 0], caches


def _layer_decode_tp(p: list, cfg: ModelConfig, kind: str, x: torch.Tensor,
                     caches: list, pos: torch.Tensor, shared: list | None,
                     memory: torch.Tensor | None, tp) -> torch.Tensor:
    """:func:`_layer_decode` over the held shards' trees ``p`` and cache
    slices ``caches``, written in place."""
    norms = _one(p, tp)
    if _is_mamba(kind):
        x = x + L.mamba_decode_tp(_sub(p, "mixer", tp), cfg,
                                  L.norm_fwd(norms["ln1"], x),
                                  [c["ssm"] for c in caches], tp)
        if kind == "mamba":
            return x
        return x + L.attention_decode_tp(
            _sub(shared, "attn", tp), cfg, L.norm_fwd(norms["ln_sh"], x),
            [c["attn"] for c in caches], pos, tp)
    x = x + L.attention_decode_tp(_sub(p, "attn", tp), cfg,
                                  L.norm_fwd(norms["ln1"], x),
                                  [c["attn"] for c in caches], pos, tp,
                                  window=_window(cfg, kind))
    if kind == "cross":
        if memory is None:
            raise ValueError(f"{cfg.name}: a cross layer's decode under a "
                             f"model axis needs the cache's memory")
        x = x + L.cross_decode_tp(_sub(p, "xattn", tp), cfg,
                                  L.norm_fwd(norms["lnx"], x), memory, tp)
    return x + _ffn(p, cfg, x, tp)[0]


def _decode_tp(params: Any, cfg: ModelConfig, token: torch.Tensor,
               caches: list, tp) -> tuple[torch.Tensor, list]:
    """:func:`decode_step` under the model axis ``tp``: each layer split
    over ``model`` as in training, its cache slices written in place
    (``layers.attention_decode_tp``, ``mamba_decode_tp``); the logits
    gathered whole over ``model``.  Where the rules split a KV sequence
    over ``data``, each layer's k and v are the held data shards' slices
    (a list, the repeat's views of each), which the attention combines
    over ``data``.  Returns (logits (B, 1, V), the held shards' cache
    trees at ``pos + 1``)."""
    pos = caches[0]["pos"]
    memory = caches[0].get("memory")
    x = _embed(params, cfg, token, tp)
    shared = _shared(params, tp)
    for i, kind in enumerate(cfg.prefix_layers):
        x = _layer_decode_tp([q["prefix"][i] for q in params], cfg, kind, x,
                             [c["prefix"][i] for c in caches], pos, shared,
                             memory, tp)
    blocks = _sub(params, "blocks", tp)
    for r in range(cfg.num_repeats):
        block = _repeat_of(blocks, r, tp)
        views = [_block(c["blocks"], r) for c in caches]
        for i, kind in enumerate(cfg.block_pattern):
            x = _layer_decode_tp(_sub(block, f"l{i}", tp), cfg, kind, x,
                                 [v[f"l{i}"] for v in views], pos, shared,
                                 memory, tp)
        del block
    x = L.norm_fwd(_one(params, tp)["final_norm"], x)
    nxt = pos + 1
    return _logits_tp(params, cfg, x, tp), [{**c, "pos": nxt}
                                            for c in caches]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _nll_tp(cfg: ModelConfig, heads: list, h: torch.Tensor,
            labels: torch.Tensor, tp) -> torch.Tensor:
    """:func:`_nll` of the hidden states ``h`` over the held shards'
    ``heads``, in vocab-parallel form: each shard's softcapped float32
    logits over its columns; the largest logit, a max over the shards
    (exact, no gradient: the log-sum-exp does not depend on it); the
    model-summed sums of ``exp(logit - max)``; and the label's logit,
    picked by the shard that owns it and model-summed.  The loss is
    ``max + log(sum) - logit[label]``, as ``log_softmax`` gives it."""
    if "vocab" not in tp.split:
        return _nll(_logits(None, cfg, h, heads[0]), labels)
    logits = [_logits(None, cfg, hi, w)
              for hi, w in zip(tp.broadcast(h), heads)]
    top = tp.max([lg.amax(dim=-1) for lg in logits])
    total = tp.model_sum([torch.exp(lg - top[..., None]).sum(dim=-1)
                    for lg in logits])
    lab, picked = labels.long(), []
    for lg, t in zip(logits, tp.held):
        n = lg.shape[-1]
        local = lab - t * n
        mine = (local >= 0) & (local < n)
        got = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        picked.append(torch.where(mine, got, 0))
    return top + torch.log(total) - tp.model_sum(picked)


def _chunk_nll(params: Params, cfg: ModelConfig, head: torch.Tensor,
               h: torch.Tensor, labels: torch.Tensor, tp=None
               ) -> torch.Tensor:
    """The float32 sum of one chunk's negative log-likelihoods."""
    if tp is not None:
        return _nll_tp(cfg, head, h, labels, tp).sum()
    return _nll(_logits(params, cfg, h, head), labels).sum()


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, memory: torch.Tensor | None = None,
            tp=None) -> torch.Tensor:
    """Mean next-token negative log-likelihood, ``log_softmax`` in
    float32, plus ``router_aux_loss_weight * aux``, as the reference adds
    it (without MoE layers ``aux`` is 0.0, which changes no loss);
    ``memory`` (B, T, D) feeds the cross layers.

    With a ``loss_seq_chunk`` c that divides S and is below it, the full
    (B, S, V) logits are never made: :func:`forward_hidden`, then for each
    chunk of c positions in order, under a checkpoint, its head product
    and the sum of its negative log-likelihoods, added into a float32
    total from 0; the mean is that total over B * S, as the reference
    divides it.

    Under a model axis ``tp`` ``params`` are the held shards' trees (see
    :func:`forward_hidden`) and the head and the loss run vocab-parallel
    (:func:`_nll_tp`), chunk by chunk with ``loss_seq_chunk``."""
    sc, (B, S) = cfg.loss_seq_chunk, tokens.shape
    if sc and S % sc == 0 and S > sc:
        hidden, aux = forward_hidden(params, cfg, tokens, memory, tp)
        head = _head(params, cfg, tp)
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for start in range(0, S, sc):
            total = total + checkpoint(
                _chunk_nll, params, cfg, head, hidden[:, start:start + sc],
                labels[:, start:start + sc], tp, use_reentrant=False)
        return total / (B * S) + cfg.router_aux_loss_weight * aux
    if tp is not None:
        hidden, aux = forward_hidden(params, cfg, tokens, memory, tp)
        nll = _nll_tp(cfg, _head(params, cfg, tp), hidden, labels, tp)
        return torch.mean(nll) + cfg.router_aux_loss_weight * aux
    logits, aux = forward_aux(params, cfg, tokens, memory)
    return torch.mean(_nll(logits, labels)) + \
        cfg.router_aux_loss_weight * aux


def param_count(params: Params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_group_key(path_names: tuple[str, ...]) -> str:
    """The layer group of a parameter path, for the layer-grouped
    ``ShardedFlatLayout`` of the worker-parallel steps, as the
    reference's: one group per position ``l{i}`` of the block pattern
    (its leaves stacked over ``num_repeats``), one per prefix layer
    (``prefix.#{i}``), ``head`` for ``lm_head``, one per other top-level
    module (``embed``, ``final_norm``, ``shared_attn``, and the audio
    ``encoder``, its leaves stacked over ``encoder_layers``, and
    ``enc_norm``) and ``misc`` for an empty path."""
    if not path_names:
        return "misc"
    head = path_names[0]
    if head in ("blocks", "prefix") and len(path_names) > 1:
        return f"{head}.{path_names[1]}"
    if head == "lm_head":
        return "head"
    return head
