"""The train, prefill and decode steps of every (architecture x input
shape) placed over a (data, model) mesh: ``build_step``.

Counterpart of ``repro.launch.steps``'s ``build_step`` and the pieces it
assembles (``model_inputs``, ``abstract_params``, ``abstract_cache``,
``opt_state_specs``, ``train_state_specs``, ``make_prefill_step``,
``make_decode_step``).  The reference jits each step with the rule
tables' shardings and lets GSPMD partition it; here a process holds its
part of the mesh and runs it:

* the weights as the blocks ``[model][data]`` of its model shards
  (``world.model_shards``) and data shards (``world.workers``): train and
  prefill and decode by ``param_specs`` (each weight's rows over
  ``data``, gathered over ``data`` on use, ``distributed.fsdp``), or, with
  ``serve_tp`` outside training, by ``serve_param_specs`` (whole over
  ``data``, nothing gathered) where the parameter bytes fit the budget;
* the modules split over ``model`` as in training
  (``distributed.tensor_parallel``), prefill and decode included
  (``models.transformer.prefill`` and ``decode_step`` under ``tp``), each
  held model shard's decode cache a tensor of its own by ``cache_specs``,
  and ``flash_decode`` run by each model shard over its own KV heads;
* the batch rows of its data shards (``batch_partition``), or every row
  where the batch does not divide the data axes: then the rules split
  each KV cache's sequence over ``data`` instead (the long-context
  decode, ``long_500k`` at batch 1), the process holds its data shards'
  slices of it, each attends its slice (``flash_decode_partial`` or the
  masked partial) and the partial softmaxes are combined over ``data``
  (``models.layers._split_attend``);
* train: the pytree GBA step (``launch.programs.make_placed_train_step``)
  with the arch's optimizer (``ARCH_OPTIMIZER``, Adam at 1e-3 by
  default), its params, accumulator and optimizer leaves held as (data,
  model) blocks by ``train_state_specs``, ``count``, ``micro`` and
  ``gstep`` whole.

``build_step`` returns ``(step, args)``: ``args`` are meta tensors of
exactly what the process holds (the reference's ``ShapeDtypeStruct``
stand-ins), and ``step(*args)`` runs on them or on concrete tensors of
the same shapes; ``step.place_params``, ``init_state``, ``place_batch``
and ``place_cache`` turn whole trees into the held blocks on their
device.  The reference's ``moe_ep`` constrains the MoE dispatch buffers
to the model axis; over ``model`` each shard already dispatches to its
own experts (``models.layers.moe_tp``), so it is taken and changes
nothing.  The reference replicates the activations of a decode whose
batch does not divide the data axes and lets GSPMD partition the cache
write and the softmax over the split sequence; here every data shard
runs the replicated batch, writes the new row where its slice holds the
slot, and the softmax is combined in data-shard order, where GSPMD
reduces in an order of its own.  The reference's deprecated shims over
``launch.programs`` are not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import GBAConfig, InputShape, ModelConfig
from repro_torch.distributed import fsdp, inprocess
from repro_torch.distributed import sharding as S
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import programs as P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, get_optimizer

Params = dict[str, Any]

# the reference's optimizer of the compiled train step
LR = 1e-3


def model_inputs(cfg: ModelConfig, shape: InputShape,
                 rows: int | None = None) -> dict[str, torch.Tensor]:
    """Meta inputs of one input shape, ``rows`` sequences (the global
    batch by default): ``tokens`` (and ``labels`` for train) int32, and
    the VLM's ``image_embeds`` or the audio model's ``frames`` (rows, T,
    d_model) in the model dtype; decode takes one new token (rows, 1), its
    memory living in the cache."""
    b = shape.global_batch if rows is None else rows
    meta = torch.device("meta")

    def ints(*s):
        return torch.empty(s, dtype=torch.int32, device=meta)

    if shape.kind == "decode":
        return {"tokens": ints(b, 1)}
    out = {"tokens": ints(b, shape.seq_len)}
    if shape.kind == "train":
        out["labels"] = ints(b, shape.seq_len)
    dt = L.dtype_of(cfg)
    if cfg.family == "vlm":
        out["image_embeds"] = torch.empty((b, cfg.num_image_tokens,
                                           cfg.d_model), dtype=dt,
                                          device=meta)
    if cfg.family == "audio":
        out["frames"] = torch.empty((b, cfg.encoder_frames, cfg.d_model),
                                    dtype=dt, device=meta)
    return out


def abstract_params(cfg: ModelConfig) -> Params:
    """The whole parameter tree as meta tensors."""
    return T.param_shapes(cfg)


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   memory_len: int = 0) -> Params:
    """The whole decode cache as meta tensors."""
    return T.cache_shapes(cfg, batch, cache_len, memory_len)


def _memory_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    if cfg.family == "audio":
        return cfg.encoder_frames
    return 0


def opt_state_specs(optimizer: Optimizer, pspecs: Any) -> Any:
    if optimizer.name == "adam":
        return {"m": pspecs, "v": pspecs, "count": ()}
    if optimizer.name == "adagrad":
        return {"accum": pspecs}
    return {}


def train_state_specs(optimizer: Optimizer, pspecs: Any) -> dict:
    return {"params": pspecs, "opt": opt_state_specs(optimizer, pspecs),
            "acc": pspecs, "micro": (), "gstep": ()}


def make_prefill_step(cfg: ModelConfig, tp=None,
                      cache_len: int | None = None):
    """``prefill_step(params, batch) -> (logits (B, V), cache)``: the
    audio encoder over ``frames``, or ``image_embeds``, as the memory; a
    cache of ``cache_len`` positions (the prompt's length by default, as
    the reference's)."""
    def prefill_step(params, batch):
        memory = batch.get("image_embeds")
        if "frames" in batch:
            memory = T.encode_audio(params, cfg, batch["frames"], tp)
        return T.prefill(params, cfg, batch["tokens"], memory=memory,
                         cache_len=cache_len, tp=tp)

    return prefill_step


def make_decode_step(cfg: ModelConfig, tp=None):
    """``decode_step(params, token, cache) -> (next_token (B, 1) int32,
    logits (B, 1, V), cache)``, ``next_token`` the greedy argmax."""
    def decode_step(params, token, cache):
        logits, cache = T.decode_step(params, cfg, token, cache, tp)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


def held_rows(mesh, world, batch: int) -> slice:
    """The batch rows of the data shards ``world`` holds (``world.workers``
    over the data axes, ``pod`` included), or every row where the batch
    does not divide them (``batch_partition`` replicates it)."""
    dp = 1
    for a in S.data_axes(mesh):
        dp *= mesh.shape[a]
    if batch % dp:
        return slice(0, batch)
    held = world.workers(dp)
    per = batch // dp
    return slice(held[0] * per, (held[-1] + 1) * per)


def arg_bytes(tree: Any) -> int:
    """The bytes of a tree of tensors and Python integers (an int32 scalar
    of the reference: 4 bytes each), each tensor counted once however
    many times the tree holds it."""
    seen: dict[int, int] = {}
    ints = 0

    def walk(x):
        nonlocal ints
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            seen[id(x)] = x.numel() * x.element_size()
        elif isinstance(x, int):
            ints += 1

    walk(tree)
    return sum(seen.values()) + 4 * ints


class PlacedStep:
    """One step of ``build_step`` on a process's part of the mesh:
    ``step(*args)`` runs it (the train step updates its state in place
    where the reference donates it), and the ``place_*`` methods give the
    held blocks of whole trees."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, mesh, world,
                 tp, placement: fsdp.Placement, gba: GBAConfig,
                 optimizer: Optimizer | None, acc_dtype: torch.dtype,
                 cache_len: int | None = None):
        self.cfg, self.shape, self.mesh, self.world = cfg, shape, mesh, world
        self.tp, self.placement, self.gba = tp, placement, gba
        self.optimizer, self.acc_dtype = optimizer, acc_dtype
        self.kind = shape.kind
        self.rows = held_rows(mesh, world, shape.global_batch)
        if self.kind == "train":
            self._fn = P.make_placed_train_step(cfg, optimizer, gba,
                                                placement, tp)
        elif self.kind == "prefill":
            self._fn = make_prefill_step(cfg, tp, cache_len)
        else:
            self._fn = make_decode_step(cfg, tp)

    def __call__(self, *args):
        if self.kind == "train":
            return self._fn(*args)
        with torch.no_grad():
            views = fsdp.serving_view(self.placement, args[0])
            return self._fn(views, *args[1:])

    def place_params(self, params: Params) -> list:
        """The held blocks ``[model][data]`` of the whole ``params``."""
        return fsdp.place(params, self.placement.specs, self.mesh,
                          self.tp.held, self.placement.held)

    def init_state(self, params: Params) -> dict:
        """The train step's held state from the whole ``params``."""
        return P.init_placed_train_state(params, self.optimizer,
                                         self.placement, self.tp.held,
                                         self.acc_dtype)

    def place_batch(self, batch: dict) -> dict:
        """The held rows of each entry of a whole batch."""
        r = self.rows
        return {k: v[r].contiguous() for k, v in batch.items()}

    def place_cache(self, cache: Params) -> list:
        """The held model shards' trees of a whole decode cache (a k or v
        split over the sequence, the held data shards' slices)."""
        batch = self.shape.global_batch
        return TP.place_cache(cache, self.cfg, self.mesh, batch,
                              self.tp.held, self.rows,
                              self.tp.seq_shards()
                              if TP.seq_split(self.mesh, batch) else None)

    def gather_cache(self, caches: list) -> Params:
        """The cache whole over ``model`` (every model shard held), and
        over ``data`` where its sequence is split (every data shard
        held)."""
        shape = self.shape
        return TP.gather_cache(caches, abstract_cache(
            self.cfg, shape.global_batch, shape.seq_len,
            _memory_len(self.cfg)), self.cfg, self.mesh, shape.global_batch)

    def gather_params(self, blocks: list) -> Params:
        """The whole tree from held blocks (every shard held): each model
        shard gathered over ``data``, then over ``model``."""
        trees = fsdp.gather(self.placement, blocks)
        return self.tp.gather_shards(trees) if len(trees) > 1 else trees[0]


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               gba: GBAConfig | None = None, serve_tp: bool = False,
               moe_ep: bool = False, *, world=inprocess,
               hbm_budget: float | None = None,
               cache_len: int | None = None
               ) -> tuple[PlacedStep, tuple]:
    """The step of ``shape.kind`` for ``cfg`` over ``mesh`` (a
    ``launch.mesh.Mesh`` with ``data`` and ``model`` axes, and ``pod``
    across pods), as the process of ``world`` holds it (every shard in
    process by default), and its meta arguments: train ``(state, batch,
    token)``, prefill ``(params, batch)``, decode ``(params, token,
    cache)``.  ``gba`` defaults to the reference's ``GBAConfig(
    local_batch=shape.global_batch, buffer_size=8)``; ``serve_tp`` places
    prefill and decode by ``serve_param_specs`` within ``hbm_budget``
    bytes (the card's memory by default); ``moe_ep`` changes nothing
    (see the module's docstring); ``cache_len`` (not the reference's)
    gives the prefill's cache more positions than the prompt, for a serve
    loop's decode steps.  A decode whose batch does not divide the data
    axes holds its data shards' slices of each KV sequence the rules
    split over ``data`` (``place_cache``)."""
    del moe_ep
    gba = gba or GBAConfig(local_batch=shape.global_batch, buffer_size=8)
    tp = TP.model_axis(cfg, mesh, world)
    pshapes = abstract_params(cfg)
    if serve_tp and shape.kind != "train":
        pspecs = S.serve_param_specs(pshapes, mesh, hbm_budget)
    else:
        pspecs = S.param_specs(pshapes, mesh)
    placement = fsdp.placement_of(pshapes, pspecs, mesh, world)
    opt, acc_dt = None, torch.float32
    if shape.kind == "train":
        opt = get_optimizer(P.ARCH_OPTIMIZER.get(cfg.name, "adam"), LR)
        acc_dt = P.ARCH_ACC_DTYPE.get(cfg.name, torch.float32)
    step = PlacedStep(cfg, shape, mesh, world, tp, placement, gba, opt,
                      acc_dt, cache_len)
    rows = step.rows.stop - step.rows.start
    binputs = model_inputs(cfg, shape, rows)
    if shape.kind == "train":
        return step, (step.init_state(pshapes), binputs, 0)
    params = step.place_params(pshapes)
    if shape.kind == "prefill":
        return step, (params, binputs)
    cache = step.place_cache(abstract_cache(
        cfg, shape.global_batch, shape.seq_len, _memory_len(cfg)))
    return step, (params, binputs["tokens"], cache)

