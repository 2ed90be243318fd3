"""The dense decoder-only transformer: embedding -> stacked blocks ->
norm -> logits, its language-model loss, and serving's prefill and
one-token decode against a KV cache.

Counterpart of ``repro.models.transformer`` for the dense architectures
(``granite-8b``): parameter names, the stacked ``blocks`` (a leading
``num_repeats`` axis, one ``l{i}`` entry per position of the block
pattern) and the arithmetic are the reference's.  The reference scans the
repeat axis with ``lax.scan``; here it is a Python loop over that axis, and
autograd gives each stacked leaf its stacked gradient.

The decode cache is the reference's tree, ``{"pos", "blocks": {"l{i}":
{"attn": {"k", "v"}}}}`` with each k and v stacked to ``(num_repeats, B,
cache_len, KV, hd)``.  ``cache["pos"]`` is an int32 tensor on the cache's
device: a scalar after :func:`prefill`, ``pos + 1`` after each
:func:`decode_step`, or the engine's (B,) vector of slot positions.
:func:`decode_step` writes the new keys and values into the cache in
place (a functional update would copy the whole cache every step) and
returns a new top-level dict that shares them.

:func:`check_supported` raises for anything else a ``ModelConfig`` can ask
for (MoE, Mamba, cross-attention, prefix layers, tied embeddings, softcaps,
sliding windows, query or loss chunking, rematerialisation, layernorm):
those come with their architectures in later slices of the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming every feature of ``cfg`` that
    the port does not run."""
    asked = []
    kinds = (set(cfg.block_pattern) | set(cfg.prefix_layers)) - {"global"}
    if kinds:
        asked.append(f"layer kinds {sorted(kinds)}")
    if cfg.prefix_layers:
        asked.append("prefix layers")
    for name in ("num_experts", "sliding_window", "logit_softcap",
                 "attn_softcap", "attn_q_chunk", "loss_seq_chunk",
                 "encoder_layers", "num_image_tokens", "tie_embeddings",
                 "remat_blocks"):
        if getattr(cfg, name):
            asked.append(name)
    if cfg.norm != "rmsnorm":
        asked.append(f"norm {cfg.norm!r}")
    if asked:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense transformer only; not "
            f"ported: {', '.join(asked)} (see ROADMAP.md)")
    L.dtype_of(cfg)


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """A ``"global"`` layer: attention and gated MLP, each after an
    RMSNorm."""
    return {"ln1": L.init_norm(cfg, gen.device),
            "attn": L.init_attention(gen, cfg),
            "ln2": L.init_norm(cfg, gen.device),
            "mlp": L.init_mlp(gen, cfg)}


def _layer_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attention_fwd(p["attn"], cfg, L.norm_fwd(p["ln1"], x),
                            positions)
    return x + L.mlp_fwd(p["mlp"], L.norm_fwd(p["ln2"], x))


def _layer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                 device: torch.device) -> Params:
    return {"attn": L.init_attn_cache(cfg, batch, cache_len, device)}


def _layer_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, seq_len: int, cache_len: int
                   ) -> tuple[torch.Tensor, Params]:
    h, (k, v) = L.attention_fwd(p["attn"], cfg, L.norm_fwd(p["ln1"], x),
                                positions, return_kv=True)
    cache = {"attn": L.kv_to_cache(cfg, k, v, seq_len, cache_len)}
    x = x + h
    return x + L.mlp_fwd(p["mlp"], L.norm_fwd(p["ln2"], x)), cache


def _layer_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  cache: Params, pos: torch.Tensor
                  ) -> tuple[torch.Tensor, Params]:
    h, attn = L.attention_decode(p["attn"], cfg, L.norm_fwd(p["ln1"], x),
                                 cache["attn"], pos)
    x = x + h
    return x + L.mlp_fwd(p["mlp"], L.norm_fwd(p["ln2"], x)), {"attn": attn}


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device: str | torch.device = "cuda") -> Params:
    """Fresh parameters: ``embed`` (V, D) at scale 0.02, ``lm_head``
    (D, V), ``final_norm`` and ``blocks`` stacked over ``num_repeats``.
    Drawn on the generator's device in a fixed order (so one seed gives the
    same parameters wherever they end up) and moved to ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)
    params: Params = {
        "embed": L._dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                               scale=0.02),
        "final_norm": L.init_norm(cfg, generator.device),
        "lm_head": L._dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                 dt),
    }
    params["blocks"] = _stack([
        {f"l{i}": _init_layer(generator, cfg)
         for i in range(len(cfg.block_pattern))}
        for _ in range(cfg.num_repeats)])
    return _map(params, lambda t: t.to(dev))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, V) float32."""
    check_supported(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(L.dtype_of(cfg))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for r in range(cfg.num_repeats):
        block = _map(params["blocks"], lambda t: t[r])
        for i in range(len(cfg.block_pattern)):
            x = _layer_fwd(block[f"l{i}"], cfg, x, positions)
    return _logits(params, L.norm_fwd(params["final_norm"], x))


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The untied head in float32: (B, S, D) -> (B, S, V)."""
    return torch.einsum("bsd,dv->bsv", x.float(), params["lm_head"].float())


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int | None = None) -> tuple[torch.Tensor, Params]:
    """Score the prompt and build the decode cache.  tokens: (B, S) int ->
    (last-position logits (B, V) float32, a cache of ``cache_len``
    positions (default S) ready for :func:`decode_step` at ``pos = S``)."""
    check_supported(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = params["embed"][tokens.long()].to(L.dtype_of(cfg))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    blocks = []
    for r in range(cfg.num_repeats):
        block = _map(params["blocks"], lambda t: t[r])
        block_c = {}
        for i in range(len(cfg.block_pattern)):
            x, block_c[f"l{i}"] = _layer_prefill(block[f"l{i}"], cfg, x,
                                                 positions, S, cache_len)
        blocks.append(block_c)
    cache = {"pos": torch.full((), S, dtype=torch.int32,
                               device=tokens.device),
             "blocks": _stack(blocks)}
    x = L.norm_fwd(params["final_norm"], x[:, -1:, :])
    return _logits(params, x)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: str | torch.device = "cuda") -> Params:
    """An empty cache at ``pos = 0``, each leaf allocated once at its
    stacked ``(num_repeats, ...)`` shape."""
    check_supported(cfg)
    dev = resolve_device(device)
    one = _layer_cache(cfg, batch, cache_len, torch.device("meta"))
    blocks = {f"l{i}": _map(one, lambda t: torch.zeros(
        (cfg.num_repeats, *t.shape), dtype=t.dtype, device=dev))
        for i in range(len(cfg.block_pattern))}
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "blocks": blocks}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params) -> tuple[torch.Tensor, Params]:
    """token: (B, 1) int -> (logits (B, 1, V) float32, the cache at
    ``pos + 1``).  The cache's k and v are written in place; every layer's
    attention goes through ``flash_decode`` when ``cache["pos"]`` is a
    scalar (see ``layers.attention_decode``)."""
    check_supported(cfg)
    pos = cache["pos"]
    x = params["embed"][token.long()].to(L.dtype_of(cfg))
    for r in range(cfg.num_repeats):
        block = _map(params["blocks"], lambda t: t[r])
        block_c = _map(cache["blocks"], lambda t: t[r])
        for i in range(len(cfg.block_pattern)):
            x, _ = _layer_decode(block[f"l{i}"], cfg, x, block_c[f"l{i}"],
                                 pos)
    x = L.norm_fwd(params["final_norm"], x)
    return _logits(params, x), {**cache, "pos": pos + 1}


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood, ``log_softmax`` in
    float32.  The reference adds ``router_aux_loss_weight * aux``, whose
    ``aux`` is 0.0 for a dense model; adding 0.0 changes no loss, so the
    port leaves it out."""
    logits = forward(params, cfg, tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return torch.mean(nll)


def param_count(params: Params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def param_group_key(path_names: tuple[str, ...]) -> str:
    """The layer group of a parameter path, for the layer-grouped
    ``ShardedFlatLayout`` of the worker-parallel step: one group per
    position ``l{i}`` of the block pattern (its leaves stacked over
    ``num_repeats``), ``head`` for ``lm_head``, and one group per other
    top-level module (``embed``, ``final_norm``).  The reference's prefix
    layers, shared attention and encoder groups come with their
    architectures."""
    head = path_names[0]
    if head == "blocks":
        return f"blocks.{path_names[1]}"
    if head == "lm_head":
        return "head"
    return head
