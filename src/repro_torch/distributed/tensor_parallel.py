"""Tensor parallelism over the mesh's ``model`` axis: which modules split,
and the collectives that join the shards, as autograd functions.

The reference partitions its forward and backward over ``model`` with
GSPMD, from the rule tables of ``repro.distributed.sharding``.  The port
runs the same split by hand.  A process holds a run of consecutive model
shards (all T in process, or T / Rm on each rank of an (Rd x Rm) grid of
ranks), one parameter tree each (``sharding.place``), and runs every
split module once a held shard on that shard's slice:

* attention (self, cross, the audio encoder's and zamba2's shared one):
  the q, k and v heads split, which keeps GQA's groups whole when the KV
  heads divide T (head ``n = kv * G + g``); ``wo`` is row-parallel, its
  float32 partials model-summed.  Where the rules fall back to head_dim,
  the specs give one of two designs.  The q heads divide T and the KV
  heads do not (``wk`` and ``wv`` split along head_dim, or stay whole
  where head_dim does not divide T either): each shard projects its
  head_dim slice of k and v for every KV head, the slices are gathered,
  RoPE runs on the whole head_dim, and each shard attends its H / T
  query heads against the KV heads they use.  The q heads do not divide
  T either (every projection and ``wo`` along head_dim): q, k and v are
  gathered and attended whole, and each shard feeds its head_dim slice
  of the output through its rows of ``wo``;
* the dense MLP: ``wi_gate`` and ``wi_up`` column-parallel, ``wo``
  row-parallel;
* the MoE FFN: the router's expert columns all-gathered into the full
  logits, so every shard routes alike, each shard's experts run on their
  own (E / T, cap, D) block, and the gathered (tokens x K, D) entries are
  model-summed before the combine (each entry is nonzero on one shard
  alone, so the sum is exact);
* the embedding and the head: a vocab-parallel lookup, vocab-parallel
  logits, and the loss's ``log_softmax`` in vocab-parallel form (tied
  embeddings too: each shard's rows take the lookup's gradient and the
  head's);
* the Mamba2 mixer: the leaves the rules split (the columns of
  ``in_proj``, of the convs and of the split projections, the rows of
  ``out_proj``) are gathered whole (:meth:`ModelAxis.whole`), and the
  mixer runs once over the process's batch rows, its output whole: a
  column block of the fused ``in_proj`` mixes the z, x, B, C and dt
  streams, so no shard can run its block alone.

Where the rules split a decode cache's KV sequence over ``data`` (a
batch that does not divide the data axes), each process holds its data
shards' slices of each k and v (:func:`place_cache`), every data shard
runs the replicated batch, and the attention's partials are joined over
``data`` in shard order (:meth:`ModelAxis.seq_gather`, ``seq_sum``,
``seq_combine``: one all-gather along the data subgroup over ranks).

A module whose leaves the rules leave whole (the dimension does not
divide T) runs whole on the first held shard's copy and is never
model-summed.  The residual stream between modules is the process's batch
rows, whole over ``model``: the reference's activation constraint
``P(data, None, None)`` (``repro.distributed.act_sharding``) is this
layout, not a global, and its ``constrain_expert`` (the MoE dispatch over
``model``) is each shard dispatching to its own experts.

The collectives: :meth:`ModelAxis.model_sum` adds the shards' partials
in shard order from +0.0, and its backward hands each held partial the
output's gradient; :meth:`ModelAxis.broadcast` hands a replicated input
to each held shard, and its backward adds the shards' gradients in shard
order from +0.0; :meth:`ModelAxis.gather` concatenates the shards'
tensors, and its backward hands each held shard its chunk of the
gradient; :meth:`ModelAxis.chunk` hands each held shard its chunk of a
replicated tensor, and its backward concatenates every shard's
gradient.  Over ranks each is one tiled all-gather along the model
subgroup (``world.model_gather``), then the same ordered sum or
concatenation, so a process that holds every shard and R ranks that
hold a run each compute the same bits.  Checkpointed regions issue them
again in the backward, in the same order on every rank.

:func:`model_axis` reads the split from the rule tables and runs every
spec they give; it refuses only a spec the rules cannot produce.  The
rule tables' ``data`` entries (FSDP) are applied beneath this module: on
the sharded fused step each held model shard's tree is gathered over
``data`` on use (``distributed.fsdp``), so the split modules here see
the trees they see without it.  What is left (the configurations that
need more than one card) waits in ROADMAP.md, queue 1 item 2.5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gba import tree_paths
from repro_torch.distributed import sharding as S

ROADMAP = "ROADMAP.md, queue 1 item 2.5"

# the leaves of each module kind that splits, by name and parent
_ATTN = ("wq", "wk", "wv", "wo")
_MAMBA = ("in_proj", "conv_w", "out_proj", "w_z", "w_x", "w_B", "w_C",
          "w_dt", "conv_x", "conv_B", "conv_C")
# the (q and wo, k and v) splits of an attention that the rules give
_ATTN_DESIGNS = {("heads", "heads"), ("heads", "head_dim"), ("heads", None),
                 ("head_dim", "head_dim"), (None, None)}


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


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, held, n, dim, x):
        ctx.world, ctx.dim = world, dim
        chunks = x.chunk(n, dim=dim)
        return tuple(chunks[t].contiguous() for t in held)

    @staticmethod
    def backward(ctx, *grads):
        every = ctx.world.model_gather([g.contiguous() for g in grads])
        return None, None, None, None, torch.cat(every, dim=ctx.dim)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One process's part of a (data W, model T) mesh: ``held``, the model
    shards it holds; ``split``, the module kinds that split over
    ``model`` (of ``"attn"``, ``"mlp"``, ``"moe"``, ``"vocab"``,
    ``"mamba"``); ``specs``, the rule tables' spec of every parameter;
    ``world``, whose ``model_gather`` joins the shards of other
    processes; ``attn``, the dimension the rules split in the attention's
    (``wq`` and ``wo``, ``wk`` and ``wv``): ``"heads"``, ``"head_dim"``
    or None (whole)."""

    mesh: Any
    world: Any
    held: range
    split: frozenset
    specs: Any
    attn: tuple = (None, None)

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

    def chunk(self, x: torch.Tensor, dim: int) -> tuple[torch.Tensor, ...]:
        """Each held shard's chunk of ``x`` (replicated) along ``dim``,
        the inverse of :meth:`gather`: the backward concatenates every
        shard's gradient in shard order, so each process's ``x`` takes
        the whole gradient."""
        return _Split.apply(self.world, tuple(self.held), self.size, dim, x)

    def max(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The elementwise largest of every shard's tensor (no gradient)."""
        every = self.world.model_gather([p.detach() for p in parts])
        out = every[0]
        for p in every[1:]:
            out = torch.maximum(out, p)
        return out

    def seq_shards(self) -> range:
        """The data shards this process holds of a KV sequence that the
        rules split over ``data`` (a batch that does not divide the data
        axes): ``world.workers`` of the ``data`` axis, whose slices of the
        cache it holds (:func:`place_cache`)."""
        return self.world.workers(self.mesh.shape["data"])

    def seq_gather(self, parts: list) -> torch.Tensor:
        """Every data shard's tensor of a sequence split over ``data``
        (each the same shape), stacked in shard order, from the held
        shards' ``parts``: one all-gather along the data subgroup over
        ranks (``world.data_gather``), the held ones in process."""
        return self.world.data_gather([p[None] for p in parts], 0)

    def seq_sum(self, parts: list) -> torch.Tensor:
        """The data shards' float32 tensors (:meth:`seq_gather`) added in
        shard order from +0.0."""
        every = self.seq_gather(parts)
        total = torch.zeros_like(every[0])
        for row in every:
            total.add_(row)
        return total

    def seq_combine(self, parts: list) -> torch.Tensor:
        """The attention output over a KV sequence split over ``data``
        from each held data shard's float32 partial ``(o (..., hd), lse
        (...))`` (``flash_decode_partial``'s), as float32: every shard's
        partial packed as one ``(..., hd + 1)`` row and gathered in shard
        order (:meth:`seq_gather`: one all-gather), then ``o = sum_s
        exp(lse_s - M) o_s / sum_s exp(lse_s - M)`` with ``M = max_s
        lse_s``, both sums in shard order from +0.0.  A shard that holds
        no position at or below ``pos`` (lse -inf) weighs 0; a row that no
        shard holds gives 0.  Processes and ranks compute the same
        bits."""
        every = self.seq_gather([torch.cat([o, lse[..., None]], dim=-1)
                                 for o, lse in parts])
        lse = every[..., -1]
        top = lse.amax(dim=0)
        top = torch.where(top == -math.inf, 0.0, top)
        num = torch.zeros_like(every[0, ..., :-1])
        den = torch.zeros_like(top)
        for row in every:
            w = torch.exp(row[..., -1] - top)
            num.add_(w[..., None] * row[..., :-1])
            den.add_(w)
        return torch.where(den[..., None] > 0, num / den[..., None], 0.0)

    def whole(self, ps: list, shapes: Any, parent: str) -> Any:
        """One module's whole tree from the held shards' trees ``ps``:
        ``shapes`` is the module's tree at its whole (unstacked) shapes,
        anything with ``.shape``, and ``parent`` its name in the rule
        tables.  A leaf the rules split is the shards' slices gathered
        along its ``model`` dimension (:meth:`gather`: the backward hands
        each held shard its chunk of the gradient), a whole leaf the first
        held shard's."""
        specs = S.param_specs({parent: shapes}, self.mesh)[parent]

        def join(spec, *leaves):
            dims = S.model_dims(spec)
            return self.gather(list(leaves), dims[0]) if dims else leaves[0]

        def walk(spec, *trees):
            if isinstance(spec, dict):
                return {k: walk(spec[k], *(t[k] for t in trees))
                        for k in spec}
            return join(spec, *trees)

        return walk(specs, *ps)

    def local_attention(self, cfg: ModelConfig) -> ModelConfig:
        """``cfg`` for one shard's heads: H / T query heads over KV / T KV
        heads, head_dim unchanged."""
        t = self.size
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // t,
                                   num_kv_heads=cfg.num_kv_heads // t,
                                   head_dim=cfg.resolved_head_dim)

    def kv_heads(self, cfg: ModelConfig, shard: int) -> torch.Tensor:
        """The KV head of each of model shard ``shard``'s H / T query
        heads: query head ``n`` uses KV head ``n // G``, so a shard
        attends its heads in groups of one, whatever the split of GQA's
        groups over the shards."""
        h = cfg.num_heads // self.size
        return torch.arange(shard * h, (shard + 1) * h) \
            // (cfg.num_heads // cfg.num_kv_heads)

    def place(self, params: Any) -> list:
        """The held shards' trees of the whole tree ``params``."""
        return [S.place(params, self.specs, self.mesh, t) for t in self.held]

    def gather_shards(self, shards: list) -> Any:
        """The whole tree from every model shard's tree (all T held)."""
        return S.gather_model_shards(shards, self.specs, self.mesh)


def seq_split(mesh, batch: int) -> bool:
    """Whether the cache rules split the KV sequence over ``data``: the
    batch does not divide the data axes (``sharding.cache_specs``)."""
    dp = 1
    for a in S.data_axes(mesh):
        dp *= mesh.shape[a]
    return batch % dp != 0


def place_cache(cache: Any, cfg: ModelConfig, mesh, batch: int,
                held: range, rows: slice | None = None,
                data_held: range | None = None) -> list:
    """The held model shards' trees of a whole decode cache, as the rule
    tables place it (``sharding.cache_specs``): each leaf cut to the batch
    ``rows`` of the held data shards (all rows by default; a leaf
    replicated over ``data`` whole), a copy of its own, then to each held
    model shard's slice along its ``model`` dimension (its KV heads, its
    head_dim columns in the fallback, the mixer state's heads, the conv
    window's channels), each slice a contiguous tensor of its own.  A leaf
    whole over ``model`` (``pos``, ``memory``, a cache the rules do not
    split) is one tensor that every held shard's tree shares, so that a
    decode writes it once.

    Where the rules split the KV sequence over ``data`` (a batch that does
    not divide the data axes), each k and v leaf that they split is the
    list of the held data shards' (``data_held``, every shard by default)
    sequence slices of each held model shard's, each a contiguous tensor
    of its own (``flash_decode`` reads one contiguous map), in shard
    order; a leaf they leave whole over ``data`` (its length does not
    divide the axis), and the Mamba2 leaves, replicated over ``data`` at
    such a batch, are cut as above."""
    specs = S.cache_specs(cache, cfg, mesh, batch)
    seq = seq_split(mesh, batch)
    if data_held is None:
        data_held = range(mesh.shape["data"])

    def cut(leaf, spec):
        dims = S.data_dims(spec)
        if seq and dims:
            return leaf                       # cut into slices below
        if dims and rows is not None:
            leaf = leaf.narrow(dims[0], rows.start, rows.stop - rows.start)
        return leaf.clone(memory_format=torch.contiguous_format)

    mine = S._zip_map(cut, cache, specs)

    def shard(t):
        def one(leaf, spec):
            if seq and S.data_dims(spec):
                return [S.place(leaf, spec, mesh, t, d) for d in data_held]
            return S.place(leaf, spec, mesh, t)
        return S._zip_map(one, mine, specs)

    return [shard(t) for t in held]


def gather_cache(caches: list, shapes: Any, cfg: ModelConfig, mesh,
                 batch: int) -> Any:
    """The cache whole over ``model`` from every model shard's tree (all T
    held, in shard order): the inverse of :func:`place_cache` over
    ``model``, over the rows the trees hold; ``shapes`` is the whole
    cache's tree (``models.transformer.cache_shapes``), whose rules say
    which leaves split.  A leaf split over the sequence is first put back
    whole over ``data`` from its slices (every data shard held)."""
    specs = S.cache_specs(shapes, cfg, mesh, batch)
    if seq_split(mesh, batch):
        def join(spec, leaf):
            if isinstance(leaf, list):
                return torch.cat(leaf, dim=S.data_dims(spec)[0])
            return leaf
        caches = [S._zip_map(join, specs, c) for c in caches]
    return S.gather_model_shards(caches, specs, mesh)


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
    if parent == "mixer" and name in _MAMBA:
        return "mamba"
    return None


def _split_kind(module: str, name: str, stacked: int, dims: list[int]
                ) -> str | None:
    """What the split of leaf ``name`` of ``module`` cuts, from its
    ``model`` dimensions: None where it stays whole; for attention
    ``"heads"`` or ``"head_dim"`` (the rules' fallback); for the others
    ``"split"`` (the vocabulary, the experts and the router's columns,
    the MLP's hidden columns and rows, the mixer's columns, and
    ``out_proj``'s rows).  ``ValueError`` for a dimension the rules never
    split."""
    if not dims:
        return None
    if module == "attn":
        heads = stacked + (0 if name == "wo" else 1)
        kinds = {heads: "heads", heads + 1: "head_dim"}
    elif module == "vocab":
        kinds = {0 if name == "embed" else 1: "split"}
    elif module == "moe":
        kinds = {stacked + (1 if name == "router" else 0): "split"}
    else:
        rows = name in ("wo", "out_proj")
        kinds = {stacked + (0 if rows else 1): "split"}
    if len(dims) != 1 or dims[0] not in kinds:
        raise ValueError(f"dimensions {dims} over model: not a split of "
                         f"the rule tables")
    return kinds[dims[0]]


def model_axis(cfg: ModelConfig, mesh, world) -> ModelAxis:
    """The model axis of ``cfg`` on ``mesh`` for a process of ``world``:
    the modules the rule tables split, checked module by module, and the
    attention's design.  Every spec the rules give runs; ``ValueError``,
    naming the leaf, for one they cannot produce: a leaf outside the
    ported modules split over model, a dimension the rules never split,
    an MLP, MoE or vocabulary split in part, or an attention whose
    projections split other than as the rules split them."""
    from repro_torch.models import transformer as T
    t = mesh.shape["model"]
    shapes = T.param_shapes(cfg)
    specs = S.param_specs(shapes, mesh)
    held = world.model_shards(t)
    if t == 1:
        return ModelAxis(mesh, world, held, frozenset(), specs)
    shapes = dict(tree_paths(shapes))
    found: dict[str, set] = {}
    attn: dict[tuple, dict] = {}
    for path, spec in tree_paths(specs):
        module, where = _module(path), "/".join(path)
        dims = S.model_dims(spec)
        if module is None:
            if dims:
                raise ValueError(f"{cfg.name}: leaf {where} splits over "
                                 f"model outside the ported modules: not a "
                                 f"spec of the rule tables ({ROADMAP})")
            continue
        stacked = sum(1 for n in path if n in ("blocks", "encoder"))
        try:
            kind = _split_kind(module, path[-1], stacked, dims)
        except ValueError as e:
            raise ValueError(f"{cfg.name}: leaf {where} "
                             f"{tuple(shapes[path].shape)}: {e} "
                             f"({ROADMAP})") from None
        if module == "attn":
            attn.setdefault(path[:-1], {})[path[-1]] = kind
        found.setdefault(module, set()).add(kind is not None)
    designs = {(a["wq"], a["wk"])
               if a["wq"] == a["wo"] and a["wk"] == a["wv"] else "mixed"
               for a in attn.values()}
    if attn and (len(designs) != 1 or not designs <= _ATTN_DESIGNS):
        raise ValueError(f"{cfg.name}: the attention projections split as "
                         f"{sorted(map(str, attn.values()))} over model {t}:"
                         f" not a split of the rule tables ({ROADMAP})")
    mixed = sorted(m for m, v in found.items()
                   if len(v) > 1 and m not in ("attn", "mamba"))
    if mixed:
        raise ValueError(f"{cfg.name}: modules {mixed} split in part over "
                         f"model {t} ({ROADMAP})")
    split = frozenset(m for m, v in found.items() if True in v)
    design = next(iter(designs)) if attn else (None, None)
    return ModelAxis(mesh, world, held, split, specs, design)
