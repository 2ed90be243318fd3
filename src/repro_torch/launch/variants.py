"""The named variants of the reference's performance study: its
``repro.launch.variants.VARIANTS``, name for name.

Each variant transforms ``(cfg, opts)``: a config and a dict of build
options.  ``baseline`` is the paper's configuration.  The config fields
that the variants set are run by the port's model code: ``attn_q_chunk``
(``models.layers.attention_fwd``), ``remat_blocks`` and
``loss_seq_chunk`` (``models.transformer``), ``mamba_split_proj``
(``models.layers.mamba_spec``) and ``moe_capacity_factor``
(``models.layers.moe_route``).  Of the options, ``gba`` is a
``GBAConfig``; ``serve_tp`` and ``moe_ep`` are carried as data, as the
reference carries them, to their reader, ``launch.steps.build_step``
(and the dry run, ``launch.dryrun``, which passes a variant's options to
it): ``serve_tp`` places prefill and decode by
``distributed.sharding.serve_param_specs``.  ``moe_ep`` changes nothing
numerically here: over the model axis each shard already dispatches to
its own experts (``models.layers.moe_tp``), the layout the reference's
``constrain_expert`` asks GSPMD for.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import GBAConfig, ModelConfig

Transform = Callable[[ModelConfig, dict], tuple[ModelConfig, dict]]


def _baseline(cfg, opts):
    return cfg, opts


def _chunked_attn(cfg, opts):
    """Queries in chunks of 1,024, each under a checkpoint: no (S, S)
    scores."""
    return dataclasses.replace(cfg, attn_q_chunk=1024), opts


def _chunked_attn_512(cfg, opts):
    return dataclasses.replace(cfg, attn_q_chunk=512), opts


def _chunked_attn_2048(cfg, opts):
    return dataclasses.replace(cfg, attn_q_chunk=2048), opts


def _serve_tp(cfg, opts):
    """Weights replicated over the data axis in serving:
    ``launch.steps.build_step`` places them by ``serve_param_specs``."""
    return cfg, {**opts, "serve_tp": True}


def _moe_capacity_1(cfg, opts):
    """MoE capacity factor 1.0: less dispatch padding."""
    if cfg.num_experts:
        return dataclasses.replace(cfg, moe_capacity_factor=1.0), opts
    return cfg, opts


def _gba_m16(cfg, opts):
    return cfg, {**opts, "gba": GBAConfig(local_batch=0, buffer_size=16)}


def _remat(cfg, opts):
    """Each repeat of the block pattern under a checkpoint: the backward
    runs the repeat again instead of keeping its activations."""
    return dataclasses.replace(cfg, remat_blocks=True), opts


def _chunked_loss(cfg, opts):
    """The head and the cross-entropy over chunks of 512 positions: no (B,
    S, V) float32 logits."""
    return dataclasses.replace(cfg, loss_seq_chunk=512), opts


def _full_opt(cfg, opts):
    """The three memory variants together."""
    return _chunked_loss(*_remat(*_chunked_attn(cfg, opts)))


def _mamba_split(cfg, opts):
    """One projection and one conv a stream in place of the fused
    ``in_proj`` and ``conv_w``."""
    return dataclasses.replace(cfg, mamba_split_proj=True), opts


def _moe_ep(cfg, opts):
    """Expert-parallel constraints on the dispatch buffers; the model
    axis's MoE is expert-parallel by construction, so nothing changes."""
    return cfg, {**opts, "moe_ep": True}


VARIANTS: dict[str, Transform] = {
    "moe_ep": _moe_ep,
    "moe_ep_full": lambda c, o: _moe_ep(*_full_opt(c, o)),
    "mamba_split": _mamba_split,
    "mamba_split_remat": lambda c, o: _remat(*_mamba_split(c, o)),
    "remat": _remat,
    "chunked_remat": lambda c, o: _remat(*_chunked_attn(c, o)),
    "chunked_loss": _chunked_loss,
    "full_opt": _full_opt,
    "full_opt_moecap1": lambda c, o: _moe_capacity_1(*_full_opt(c, o)),
    "baseline": _baseline,
    "chunked_attn": _chunked_attn,
    "chunked_attn_512": _chunked_attn_512,
    "chunked_attn_2048": _chunked_attn_2048,
    "serve_tp": _serve_tp,
    "serve_tp_chunked": lambda c, o: _serve_tp(*_chunked_attn(c, o)),
    "moe_cap1": _moe_capacity_1,
    "moe_cap1_chunked": lambda c, o: _moe_capacity_1(*_chunked_attn(c, o)),
}
