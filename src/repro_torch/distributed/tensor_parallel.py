"""Tensor parallelism over the mesh's ``model`` axis: which modules split,
and the collectives that join the shards, as autograd functions.

The reference partitions its forward and backward over ``model`` with
GSPMD, from the rule tables of ``repro.distributed.sharding``.  The port
runs the same split by hand.  A process holds a run of consecutive model
shards (all T in process, or T / Rm on each rank of an (Rd x Rm) grid of
ranks), one parameter tree each (``sharding.place``), and runs every
split module once a held shard on that shard's slice:

* attention (self, cross, and the audio encoder's): the q, k and v heads
  split, which keeps GQA's groups whole when the KV heads divide T (head
  ``n = kv * G + g``); ``wo`` is row-parallel, its float32 partials
  model-summed;
* the dense MLP: ``wi_gate`` and ``wi_up`` column-parallel, ``wo``
  row-parallel;
* the MoE FFN: the router's expert columns all-gathered into the full
  logits, so every shard routes alike, each shard's experts run on their
  own (E / T, cap, D) block, and the gathered (tokens x K, D) entries are
  model-summed before the combine (each entry is nonzero on one shard
  alone, so the sum is exact);
* the embedding and the head: a vocab-parallel lookup, vocab-parallel
  logits, and the loss's ``log_softmax`` in vocab-parallel form.

A module whose leaves the rules leave whole (the dimension does not
divide T) runs whole on the first held shard's copy and is never
model-summed.  The residual stream between modules is the process's batch
rows, whole over ``model``: the reference's activation constraint
``P(data, None, None)`` (``repro.distributed.act_sharding``) is this
layout, not a global, and its ``constrain_expert`` (the MoE dispatch over
``model``) is each shard dispatching to its own experts.

The collectives: :meth:`ModelAxis.model_sum` adds the shards' partials in shard
order from +0.0, and its backward hands each held partial the output's
gradient; :meth:`ModelAxis.broadcast` hands a replicated input to each
held shard, and its backward adds the shards' gradients in shard order
from +0.0.  Over ranks both are one tiled all-gather along the model
subgroup (``world.model_gather``), then the same ordered sum, so a
process that holds every shard and R ranks that hold a run each compute
the same bits.  Checkpointed regions issue them again in the backward,
in the same order on every rank.

:func:`model_axis` reads the split from the rule tables and refuses what
this port does not run: a Mamba layer kind over T > 1, a split that needs
the rules' head_dim fallback, and KV heads that do not divide T
(ROADMAP.md, queue 1 item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gba import tree_paths
from repro_torch.distributed import sharding as S

ROADMAP = "ROADMAP.md, queue 1 item 2"

# the leaves of each module kind that splits, by name and parent
_ATTN = ("wq", "wk", "wv", "wo")


def ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """``((0 + parts[0]) + parts[1]) + ...``: the sum in shard order from
    +0.0."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc.add_(p)
    return acc


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, *parts):
        ctx.k = len(parts)
        return ordered_sum(world.model_gather(list(parts)))

    @staticmethod
    def backward(ctx, grad):
        return (None, *([grad] * ctx.k))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, k, x):
        ctx.world = world
        return tuple(x.view_as(x) for _ in range(k))

    @staticmethod
    def backward(ctx, *grads):
        return None, None, ordered_sum(ctx.world.model_gather(list(grads)))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, held, dim, *parts):
        every = world.model_gather(list(parts))
        ctx.held, ctx.dim, ctx.n = held, dim, len(every)
        return torch.cat(every, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        chunks = grad.chunk(ctx.n, dim=ctx.dim)
        return (None, None, None, *(chunks[t].contiguous()
                                    for t in ctx.held))


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One process's part of a (data W, model T) mesh: ``held``, the model
    shards it holds; ``split``, the module kinds that split over
    ``model`` (of ``"attn"``, ``"mlp"``, ``"moe"``, ``"vocab"``);
    ``specs``, the rule tables' spec of every parameter; ``world``, whose
    ``model_gather`` joins the shards of other processes."""

    mesh: Any
    world: Any
    held: range
    split: frozenset
    specs: Any

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    def broadcast(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``x``, replicated, once for each held shard; the backward adds
        the shards' gradients in shard order from +0.0."""
        return _Broadcast.apply(self.world, len(self.held), x)

    def model_sum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' partials added in shard order from +0.0; the
        backward hands each held partial the output's gradient."""
        return _Sum.apply(self.world, *parts)

    def gather(self, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
        """Every shard's tensor concatenated along ``dim`` in shard order;
        the backward hands each held shard its chunk of the gradient."""
        return _Gather.apply(self.world, tuple(self.held), dim, *parts)

    def max(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The elementwise largest of every shard's tensor (no gradient)."""
        every = self.world.model_gather([p.detach() for p in parts])
        out = every[0]
        for p in every[1:]:
            out = torch.maximum(out, p)
        return out

    def local_attention(self, cfg: ModelConfig) -> ModelConfig:
        """``cfg`` for one shard's heads: H / T query heads over KV / T KV
        heads, head_dim unchanged."""
        t = self.size
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // t,
                                   num_kv_heads=cfg.num_kv_heads // t,
                                   head_dim=cfg.resolved_head_dim)

    def place(self, params: Any) -> list:
        """The held shards' trees of the whole tree ``params``."""
        return [S.place(params, self.specs, self.mesh, t) for t in self.held]

    def gather_shards(self, shards: list) -> Any:
        """The whole tree from every model shard's tree (all T held)."""
        return S.gather_model_shards(shards, self.specs, self.mesh)


def _module(names: tuple[str, ...]) -> str | None:
    """The module kind a parameter path belongs to, for the split."""
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    if name in ("embed", "lm_head"):
        return "vocab"
    if parent == "moe":
        return "moe"
    if parent == "mlp":
        return "mlp"
    if parent in ("attn", "xattn") and name in _ATTN:
        return "attn"
    return None


def _expected(module: str, name: str, stacked: int) -> int:
    """The dimension the split of ``module`` cuts in leaf ``name``: the
    vocabulary, the expert (the router's columns), the MLP's hidden
    columns and rows, or the attention's heads."""
    if module == "vocab":
        return 0 if name == "embed" else 1
    if module == "moe":
        return stacked + (1 if name == "router" else 0)
    return stacked + (0 if name == "wo" else 1)


def model_axis(cfg: ModelConfig, mesh, world) -> ModelAxis:
    """The model axis of ``cfg`` on ``mesh`` for a process of ``world``:
    the modules the rule tables split, checked module by module.
    ``NotImplementedError`` for a Mamba layer kind over T > 1, and
    ``ValueError`` for a split this port does not run (the head_dim
    fallback, KV heads that do not divide T, a module split in part);
    each names the leaf and ROADMAP.md."""
    from repro_torch.models import transformer as T
    t = mesh.shape["model"]
    shapes = T.param_shapes(cfg)
    specs = S.param_specs(shapes, mesh)
    held = world.model_shards(t)
    if t == 1:
        return ModelAxis(mesh, world, held, frozenset(), specs)
    kinds = set(cfg.block_pattern) | set(cfg.prefix_layers)
    mamba = sorted(kinds & {"mamba", "mamba_attn"})
    if mamba:
        raise NotImplementedError(
            f"{cfg.name}: a model axis above 1 is not ported for the layer "
            f"kinds {mamba} (model {t}): the Mamba2 mixer's fused "
            f"projection does not split over model ({ROADMAP})")
    shapes = dict(tree_paths(shapes))
    found: dict[str, set] = {}
    for path, spec in tree_paths(specs):
        module = _module(path)
        dims = S.model_dims(spec)
        if module is None:
            if dims:
                raise ValueError(f"{cfg.name}: leaf {'/'.join(path)} splits "
                                 f"over model outside a ported module "
                                 f"({ROADMAP})")
            continue
        stacked = sum(1 for n in path if n in ("blocks", "encoder"))
        want = _expected(module, path[-1], stacked)
        if dims and dims != [want]:
            raise ValueError(
                f"{cfg.name}: leaf {'/'.join(path)} {tuple(shapes[path].shape)}"
                f" splits dimension {dims} over model {t}: the rules' "
                f"head_dim fallback, which this port does not run "
                f"({ROADMAP})")
        found.setdefault(module, set()).add(bool(dims))
        if module == "attn" and path[-1] in ("wk", "wv") and not dims \
                and cfg.num_heads % t == 0:
            raise ValueError(
                f"{cfg.name}: leaf {'/'.join(path)}: {cfg.num_kv_heads} KV "
                f"heads do not divide the model axis {t} ({ROADMAP})")
    mixed = sorted(m for m, v in found.items() if len(v) > 1)
    if mixed:
        raise ValueError(f"{cfg.name}: modules {mixed} split in part over "
                         f"model {t} ({ROADMAP})")
    split = frozenset(m for m, v in found.items() if v == {True})
    return ModelAxis(mesh, world, held, split, specs)

