"""Sharding rules: params, caches and batches -> partition spec trees, and
the placement of a parameter tree on the model axis.

Counterpart of ``repro.distributed.sharding``, rule for rule.  The scheme
is the reference's 2-D "fsdp + tensor" sharding on a (data, model) mesh:

  weight matrices    rows over ``data`` (FSDP), columns over ``model``
  attention heads    the q/kv head axis over ``model`` (head_dim when the
                     head count does not divide)
  MoE experts        the expert axis over ``model``, d_model over ``data``
  embeddings/vocab   rows over ``model``, d_model over ``data``
  norms/scalars      replicated

and a ``pod`` axis, where the mesh has one, for data parallelism alone.
Every rule degrades to ``None`` where the dimension does not divide the
axis.

A spec is a plain tuple with one entry a dimension: ``None``, an axis
name, or a tuple of names (a tuple of one name is that name, as
``jax.sharding.PartitionSpec`` normalises it), so ``tuple(jax_spec) ==
spec`` compares the two packages.  The tables read shapes alone: a tree
of anything with ``.shape`` (``models.transformer.param_shapes`` and
``cache_shapes`` give meta tensors at the full size), and a mesh with
``axis_names`` and ``shape`` (``launch.mesh.Mesh``).

The port runs both axes on the sharded fused step
(``launch.programs.build_programs(mode="fused", workers=W)`` with W > 1,
at any T): the ``model`` entries split the modules over the model shards
(``distributed.tensor_parallel``), and the ``data`` entries hold each
weight's rows over the W data shards (FSDP, ``distributed.fsdp``), as
the reference's ``jax.device_put(state, to_named(specs, mesh))`` places
them.  The reference's ``to_named`` has no counterpart: :func:`place`
cuts a tree into the block one (data, model) shard holds, or, without a
data index, the slice one model shard holds; :func:`gather_data_shards`
and :func:`gather_model_shards` put the blocks back together, in that
order.

The reference's activation constraints (``act_sharding``) are a module
global that pins the residual stream to ``P(data, None, None)`` and the
MoE dispatch buffers to ``P(model, None, None)``.  Here both are the
layout itself: each process runs its batch rows with the residual stream
whole over ``model`` (``distributed.tensor_parallel``), and each model
shard dispatches to its own experts alone.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.flat_sharded import ShardedFlatLayout

Spec = tuple


def _entry(axes) -> Any:
    """An entry as ``PartitionSpec`` keeps it: a tuple of one name is that
    name, an empty tuple ``None``."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def _map_with_path(tree: Any, fn, prefix: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, a list entry
    named ``#i`` (``repro.core.flat_sharded.path_names``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(v, fn, prefix + (f"#{i}",))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _spec_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _map_specs(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return fn(tree)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis]


def _fits(dim: int, mesh, axis: str) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _maybe(dim: int, mesh, axis: str) -> str | None:
    return axis if _fits(dim, mesh, axis) else None


def _leaf_spec(names: tuple[str, ...], shape: tuple[int, ...], mesh) -> Spec:
    """The trailing dimensions' rule table; the leading stacked dimensions
    (``blocks``' repeats, the ``encoder``'s layers) are replicated."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    stacked = sum(1 for n in names if n in ("blocks", "encoder"))
    core = tuple(shape[stacked:])
    lead = (None,) * stacked

    def spec(*dims):
        return (*lead, *dims)

    if name == "embed":
        return spec(_maybe(core[0], mesh, "model"),
                    _maybe(core[1], mesh, "data"))
    if name == "lm_head":
        return spec(_maybe(core[0], mesh, "data"),
                    _maybe(core[1], mesh, "model"))
    if parent == "moe":                                     # expert parallel
        if name == "router":
            return spec(None, _maybe(core[1], mesh, "model"))
        if name in ("wi_gate", "wi_up"):
            e, d, _ = core
            return spec(_maybe(e, mesh, "model"),
                        _maybe(d, mesh, "data"), None)
        if name == "wo":
            e, _, d = core
            return spec(_maybe(e, mesh, "model"), None,
                        _maybe(d, mesh, "data"))
    if name in ("wq", "wk", "wv") and len(core) == 3:
        d, h, hd = core
        if _fits(h, mesh, "model"):
            return spec(_maybe(d, mesh, "data"), "model", None)
        return spec(_maybe(d, mesh, "data"), None,
                    _maybe(hd, mesh, "model"))
    if name == "wo" and len(core) == 3:                     # attention out
        h, hd, d = core
        if _fits(h, mesh, "model"):
            return spec("model", None, _maybe(d, mesh, "data"))
        return spec(None, _maybe(hd, mesh, "model"),
                    _maybe(d, mesh, "data"))
    if name in ("wi_gate", "wi_up") and len(core) == 2:     # dense mlp
        return spec(_maybe(core[0], mesh, "data"),
                    _maybe(core[1], mesh, "model"))
    if name == "wo" and len(core) == 2:
        return spec(_maybe(core[0], mesh, "model"),
                    _maybe(core[1], mesh, "data"))
    if name in ("in_proj", "w_z", "w_x", "w_B", "w_C", "w_dt"):  # mamba
        return spec(_maybe(core[0], mesh, "data"),
                    _maybe(core[1], mesh, "model"))
    if name in ("conv_x", "conv_B", "conv_C"):
        return spec(None, _maybe(core[1], mesh, "model"))
    if name == "out_proj":
        return spec(_maybe(core[0], mesh, "model"),
                    _maybe(core[1], mesh, "data"))
    if name == "conv_w":
        return spec(None, _maybe(core[1], mesh, "model"))
    if name in ("wx", "wh"):                                # recsys GRU
        return spec(None, None)
    # norms, biases, A_log, dt_bias, D_skip, scalars
    return spec(*([None] * len(core)))


def param_specs(params_shapes: Any, mesh) -> Any:
    """A tree of shapes (anything with ``.shape``) -> the tree of specs."""
    return _map_with_path(params_shapes, lambda path, leaf: _leaf_spec(
        path, tuple(leaf.shape), mesh))


def _shard_count(spec: Spec, mesh) -> int:
    shard = 1
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            shard *= _axis_size(mesh, a)
    return shard


def _card_bytes() -> float:
    """The memory of the CUDA card in use, the default budget of
    :func:`serve_param_specs`."""
    if not torch.cuda.is_available():
        raise ValueError("serve_param_specs: no CUDA card to read a budget "
                         "from; pass hbm_budget")
    return float(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


def serve_param_specs(params_shapes: Any, mesh,
                      hbm_budget: float | None = None) -> Any:
    """Inference sharding (the reference's ``serve_tp`` variant): the
    ``data`` (FSDP) axis dropped from every weight's spec, pure tensor
    parallelism, when the per-device parameter bytes then fit
    ``hbm_budget``; else :func:`param_specs`.  The budget is the caller's,
    in bytes; by default it is the memory of the CUDA card in use
    (``torch.cuda.get_device_properties(...).total_memory``), and without a
    card it must be given.  The reference's default, 8e9, is a TPU figure
    and is not taken here."""
    budget = _card_bytes() if hbm_budget is None else float(hbm_budget)
    pspecs = param_specs(params_shapes, mesh)
    dropped = _map_specs(
        lambda spec: tuple(None if ax == "data" else ax for ax in spec),
        pspecs)
    total = 0.0
    for leaf, spec in zip(_spec_leaves(params_shapes),
                          _spec_leaves(dropped)):
        total += (leaf.numel() * leaf.dtype.itemsize
                  / _shard_count(spec, mesh))
    return dropped if total <= budget else pspecs


def stacked_specs(specs: Any, lead: int = 1) -> Any:
    """``lead`` replicated dimensions before each spec (the M-slot GBA
    buffer over the params)."""
    return _map_specs(lambda s: (*((None,) * lead), *s), specs)


# ---------------------------------------------------------------------------
# the flat-sharded GBA state (core.flat_sharded.ShardedFlatLayout)
# ---------------------------------------------------------------------------

def flat_slice_specs(layout: ShardedFlatLayout, mesh, axis: str = "data"
                     ) -> dict:
    """Specs of a ``ShardedFlatLayout``'s state: the flat params and
    accumulator split over ``axis`` (each PS shard one contiguous
    tile-aligned slice), the buffer's columns likewise with the M slot
    axis replicated, the slot tokens, fill and step replicated.

    Checks the layout against the mesh, as the reference's does: one
    shard a device on ``axis``, a padded total that splits evenly, and a
    self-consistent table of layer groups (each a whole number of
    ``num_shards * tile`` chunks, summing to the padded total, every leaf
    in a real group); ``ValueError`` otherwise."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    n_dev = _axis_size(mesh, axis)
    if layout.num_shards != n_dev:
        raise ValueError(
            f"layout has {layout.num_shards} shards, mesh axis {axis!r} "
            f"has {n_dev} devices")
    if layout.padded_total != layout.num_shards * layout.shard_size:
        raise ValueError(
            f"layout padded_total {layout.padded_total} != "
            f"{layout.num_shards} * {layout.shard_size}")
    chunk = layout.num_shards * layout.tile
    for key, gs in zip(layout.group_keys, layout.group_sizes):
        if gs % chunk:
            raise ValueError(
                f"layer group {key!r} extent {gs} is not a multiple of "
                f"num_shards * tile = {chunk}")
    if sum(layout.group_sizes) != layout.padded_total:
        raise ValueError(
            f"layer groups cover {sum(layout.group_sizes)} elements, "
            f"layout padded_total is {layout.padded_total}")
    if any(g >= len(layout.group_keys) for g in layout.leaf_group):
        raise ValueError("leaf_group indexes past the group table")
    return {
        "flat": (axis,),
        "buffer": {"grads": (None, axis), "tokens": (), "fill": (),
                   "step": ()},
    }


def wire_state_specs(layout: ShardedFlatLayout, mesh, scheme: str,
                     axis: str = "data") -> dict:
    """Specs of the compressed wire's per-worker state (``(M,
    padded_total)`` rows, row ``w`` worker ``w``'s: split over ``axis`` on
    the worker axis), one a ``layout.wire_state_shapes`` entry ({} for
    ``"none"``), after :func:`flat_slice_specs`'s checks."""
    flat_slice_specs(layout, mesh, axis)
    m = _axis_size(mesh, axis)
    return {name: (axis, None)
            for name in layout.wire_state_shapes(m, scheme)}


def fused_state_specs(layout, mesh, pspecs: Any, axis: str = "data"
                      ) -> dict:
    """The fused step's state specs: the params by their rules
    (``pspecs``), the Adagrad accumulator and the M-slot buffer flat,
    sliced over ``axis`` for a ``ShardedFlatLayout`` (after its checks),
    replicated for the single ``FlatLayout``."""
    if isinstance(layout, ShardedFlatLayout):
        flat = flat_slice_specs(layout, mesh, axis)
    else:
        flat = {"flat": (), "buffer": {"grads": (), "tokens": (),
                                       "fill": (), "step": ()}}
    return {"params": pspecs, "accum": flat["flat"],
            "buffer": flat["buffer"]}


def cache_specs(cache_shapes: Any, cfg, mesh, batch: int) -> Any:
    """Decode-cache specs: the batch over (pod, data) where it divides,
    else (one long sequence) the KV sequence over ``data``; KV heads over
    ``model``, or head_dim where they do not divide."""
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= _axis_size(mesh, a)
    batch_ok = batch % dp_size == 0
    bspec = _entry(dp) if batch_ok else None
    seq_axis = None if batch_ok else "data"

    def per_leaf(names, leaf):
        name = names[-1]
        stacked = 1 if "blocks" in names else 0
        lead = (None,) * stacked
        core = tuple(leaf.shape[stacked:])
        if name in ("k", "v"):
            _, length, kv, hd = core
            kvs = _maybe(kv, mesh, "model")
            hds = None if kvs else _maybe(hd, mesh, "model")
            ls = seq_axis if (seq_axis and _fits(length, mesh, "data")) \
                else None
            return (*lead, bspec, ls, kvs, hds)
        if name == "ssm":
            _, h, _, _ = core
            return (*lead, bspec, _maybe(h, mesh, "model"), None, None)
        if name == "conv":
            _, _, c = core
            return (*lead, bspec, None, _maybe(c, mesh, "model"))
        if name == "memory":
            return (bspec, None, None)
        return (None,) * len(leaf.shape)              # pos, a scalar

    return _map_with_path(cache_shapes, per_leaf)


def batch_partition(mesh, batch: int, ndim: int) -> Spec:
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= _axis_size(mesh, a)
    lead = _entry(dp) if batch % dp_size == 0 else None
    return (lead, *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# placement on the model axis
# ---------------------------------------------------------------------------

def model_dims(spec: Spec) -> list[int]:
    """The dimensions a spec splits over ``model``."""
    return _axis_dims(spec, "model")


def data_dims(spec: Spec) -> list[int]:
    """The dimensions a spec splits over ``data`` (FSDP)."""
    return _axis_dims(spec, "data")


def _axis_dims(spec: Spec, axis: str) -> list[int]:
    return [d for d, ax in enumerate(spec)
            if ax == axis or (isinstance(ax, tuple) and axis in ax)]


def _model_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


def _data_size(mesh) -> int:
    return mesh.shape["data"] if "data" in mesh.axis_names else 1


def place(tree: Any, specs: Any, mesh, model_index: int,
          data_index: int | None = None) -> Any:
    """The tree that model shard ``model_index`` holds: each leaf cut
    along its ``model`` dimensions to that shard's contiguous slice, a
    copy of its own; a leaf the rules leave whole over ``model`` is
    returned as it is (the same tensor).  With ``data_index`` the block
    that data shard ``data_index`` of that model shard holds: each leaf
    also cut along its ``data`` dimension to the ``data_index``-th of its
    contiguous rows, as ``jax.device_put(x, NamedSharding(mesh, spec))``
    lays out the block of device (``data_index``, ``model_index``), and
    every leaf a copy of its own (a leaf whole over both axes too)."""
    t_size, w_size = _model_size(mesh), _data_size(mesh)
    if not 0 <= model_index < t_size:
        raise IndexError(f"model shard {model_index} of {t_size}")
    if data_index is not None and not 0 <= data_index < w_size:
        raise IndexError(f"data shard {data_index} of {w_size}")

    def cut(leaf, spec):
        cuts = [] if t_size == 1 else [(d, t_size, model_index)
                                       for d in model_dims(spec)]
        if data_index is not None:
            cuts += [(d, w_size, data_index) for d in data_dims(spec)]
        if not cuts and data_index is None:
            return leaf
        for d, size, index in cuts:
            n = leaf.shape[d] // size
            leaf = leaf.narrow(d, index * n, n)
        return leaf.clone(memory_format=torch.contiguous_format)

    return _zip_map(cut, tree, specs)


def gather_data_shards(blocks: list, specs: Any, mesh) -> Any:
    """A model shard's tree from its every data shard's block (in data
    shard order): each leaf split over ``data`` the blocks' rows
    concatenated along that dimension, each other leaf block 0's.  The
    inverse of :func:`place` over ``data``."""
    w_size = _data_size(mesh)
    if len(blocks) != w_size:
        raise ValueError(f"{len(blocks)} blocks for a data axis of "
                         f"{w_size}")

    def join(spec, *leaves):
        dims = data_dims(spec)
        if not dims or w_size == 1:
            return leaves[0]
        return torch.cat(leaves, dim=dims[0])

    return _zip_map(join, specs, *blocks)


def gather_model_shards(shards: list, specs: Any, mesh) -> Any:
    """The whole tree from every model shard's tree (in shard order): each
    split leaf the shards' slices concatenated along its ``model``
    dimension, each whole leaf shard 0's.  The inverse of :func:`place`
    over ``model``."""
    t_size = _model_size(mesh)
    if len(shards) != t_size:
        raise ValueError(f"{len(shards)} shard trees for a model axis of "
                         f"{t_size}")

    def join(spec, *leaves):
        dims = model_dims(spec)
        if not dims or t_size == 1:
            return leaves[0]
        if len(dims) > 1:
            raise ValueError(f"a spec {spec} splits more than one "
                             f"dimension over model")
        return torch.cat(leaves, dim=dims[0])

    return _zip_map(join, specs, *shards)


def block_bytes(shapes: Any, specs: Any, mesh) -> int:
    """The bytes of the block one (data, model) shard holds of a tree of
    ``shapes`` (anything with ``.shape`` and ``.dtype``) under ``specs``:
    each leaf's bytes over the devices its spec splits it across."""
    total = 0
    for leaf, spec in zip(_spec_leaves(shapes), _spec_leaves(specs)):
        total += leaf.numel() * leaf.dtype.itemsize // _shard_count(spec,
                                                                   mesh)
    return total


def _zip_map(fn, first: Any, *rest: Any) -> Any:
    if isinstance(first, dict):
        return {k: _zip_map(fn, first[k], *(r[k] for r in rest))
                for k in first}
    if isinstance(first, list):
        return [_zip_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(first)]
    return fn(first, *rest)
