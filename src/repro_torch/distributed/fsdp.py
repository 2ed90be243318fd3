"""FSDP of the weights over ``data`` on the sharded fused step: each
layer gathered on use, its gradient reduced over ``data`` in float32.

The reference places the sharded fused step's parameters by the rule
tables (``jax.device_put(state, to_named(specs, mesh))``): each weight's
rows over the ``data`` axis, its columns over ``model``.  GSPMD then
gathers a weight where the forward uses it and reduce-scatters its
gradient.  The port does this by hand, and the reference has no module
that this one mirrors.

A process holds, for each of its model shards and each of its data
shards, the block ``sharding.place(tree, specs, mesh, m, d)``: the
model shard's slice of every leaf cut to the data shard's rows along the
leaf's ``data`` dimension, a leaf the rules leave whole over ``data``
copied whole (:class:`Placement` describes the cut).  Between microsteps
that is all it holds of the weights: the rules' share of each (data,
model) block.

In a microstep (:class:`Microstep`) the model code reads the params
through :class:`Top` (one a held model shard).  A top-level module
(``embed``, ``lm_head``, ``final_norm``, ``shared_attn``, ``prefix``,
``encoder``, ``enc_norm``) is gathered on its first use and kept for the
microstep, so a leaf used more than once (zamba2's shared attention in
every ``mamba_attn`` layer, a tied ``embed`` as the lookup and the head)
is gathered once and autograd adds its uses in the weight's dtype before
the one data reduction, as it adds them on a whole leaf.  ``blocks`` are
gathered a repeat at a time (:func:`repeat`), inside the repeat's
checkpoint (``models.transformer.forward_hidden``): the forward keeps
no repeat's gathered weights, and the backward runs the repeat again,
gathering its weights again.  After the gather over ``data`` each model
shard sees the tree it sees without FSDP, so the model axis
(``distributed.tensor_parallel``) runs unchanged.

The gather is an autograd function (:class:`_Use`) of a zero ``anchor``
that requires a gradient.  Its backward casts the weight's gradient to
float32 and reduces it over the data ranks (``world.data_reduce``, a
reduce-scatter along the leaf's ``data`` dimension), and writes the held
rows into the microstep's ``sink``, outside autograd's ``.grad`` (which
would round them back to the weight's dtype).  A leaf whole over
``data`` keeps its rank's float32 partial there.  A leaf whole over
``model`` is used, and so reduced, on the first held model shard alone;
the other held shards read its sink.

The flat GBA state (accumulator and buffer) keeps the layout of the
sharded fused step without FSDP: each model shard's
``ShardedFlatLayout`` split over the W data shards by columns, which are
not the leaves' rows.  Three re-layouts join them, each a window at a
time: ``c`` columns of every data shard's part of a layer group, a (W,
c) float32 block of at most ``WINDOW`` elements, filled from (or into)
the slabs it meets, a slab a leaf or one repeat of a stacked leaf
(:func:`transient_bytes` bounds what one holds at once):

* :func:`push`, a microstep's gradient, rows to columns: the window
  filled with the held rows, ``-0.0`` at the other ranks' rows (the
  additive identity, so the sum is the owner's value bit for bit) and
  each whole-over-data leaf's partial, then ``world.reduce_scatter``,
  whose sum of the partials is the step's without FSDP;
* :func:`columns`, before an apply, the params rows to columns: the same
  with the params, each column given by the one rank that holds it;
* :func:`rows`, after it, columns to rows: the window's updated columns
  gathered (``world.gather_flat``) into the slabs, each slab cut into
  the held blocks' rows once whole, in place.

No process ravels a whole-tree gradient.  On one process, or over two
data ranks (where any order of a two-term sum gives the same bits), the
step is the step without FSDP bit for bit.

Two more steps hold their params as such blocks, over a
:func:`placement_of` that needs no flat state (``launch.steps``): the
placed serving steps read them through :func:`serving_view` (a
:class:`Microstep` without gradient sinks, under ``torch.no_grad``), and
the placed pytree step (``launch.programs.make_placed_train_step``) runs
a :class:`Microstep` and adds each leaf's reduced rows
(:func:`grad_rows`) into its accumulator's blocks, with no re-layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import path_leaves, path_unflatten
from repro_torch.distributed import sharding as S
from repro_torch.optim import tree_map


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a process holds one model shard's tree over ``data``:
    ``layout``, the model shard's ``ShardedFlatLayout``; ``specs`` and
    ``mesh``, the rule tables' specs of the whole tree and the (data,
    model) mesh they place it on; for each of its
    leaves (layout order) ``dims``, the ``data`` dimension (None where the
    rules leave the leaf whole over ``data``), ``rows``, a data shard's
    rows along it, and ``whole``, whether the rules leave the leaf whole
    over ``model``; ``held``, the data shards this process holds;
    ``world``, whose ``data_gather``, ``data_reduce``, ``reduce_scatter``
    and ``gather_flat`` run along the data subgroup."""

    layout: ShardedFlatLayout
    specs: Any
    mesh: Any
    dims: tuple
    rows: tuple
    whole: tuple
    held: range
    world: Any

    @classmethod
    def of(cls, layout: ShardedFlatLayout, specs: Any, mesh, world
           ) -> "Placement":
        """The placement of ``layout`` (W = ``layout.num_shards`` data
        shards) by the rule tables' ``specs`` of the whole tree on
        ``mesh``."""
        w = layout.num_shards
        dims, rows, whole = [], [], []
        for shape, spec in zip(layout.shapes,
                               path_leaves(layout.paths, specs)):
            d = S.data_dims(spec)
            dims.append(d[0] if d else None)
            rows.append(shape[d[0]] // w if d else 0)
            whole.append(not S.model_dims(spec))
        return cls(layout, specs, mesh, tuple(dims), tuple(rows),
                   tuple(whole), world.workers(w), world)

    @property
    def rank(self) -> int:
        """This process's data coordinate."""
        return self.held[0] // len(self.held)


def place(params: Any, specs: Any, mesh, model_held, data_held) -> list:
    """The blocks a process holds of the whole tree ``params``: for each
    model shard of ``model_held``, for each data shard of ``data_held``,
    ``sharding.place(params, specs, mesh, m, d)``."""
    return [[S.place(params, specs, mesh, m, d) for d in data_held]
            for m in model_held]


class _Use(torch.autograd.Function):
    """A leaf whole over ``data`` from the held rows ``parts`` (``dim``
    None: the first block's copy); the backward writes the held rows of
    the float32 gradient reduced over ``data`` into ``sink`` (the rank's
    partial where ``dim`` is None) and hands autograd nothing."""

    @staticmethod
    def forward(ctx, world, dim, sink, anchor, *parts):
        ctx.world, ctx.dim, ctx.sink, ctx.n = world, dim, sink, len(parts)
        if dim is None:
            return parts[0].view_as(parts[0])
        return world.data_gather(list(parts), dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        ctx.sink.copy_(g if ctx.dim is None
                       else ctx.world.data_reduce(g, ctx.dim))
        return (None, None, None, None, *([None] * ctx.n))


class Microstep:
    """One microstep's view of the held ``blocks`` (``[model][data]``
    trees): the gathers on use, the ``anchor`` whose backward runs them,
    and the ``sink`` of float32 gradient rows, ``sink[i][j]`` for held
    model shard ``i`` and leaf ``j``: the held data shards' rows (``k_d``
    times a data shard's along the leaf's ``data`` dimension), or the
    whole leaf for one whole over ``data``; zeros where the loss does not
    reach the leaf, as ``jax.grad`` gives them."""

    def __init__(self, placement: Placement, blocks: list,
                 grad: bool = True):
        self.p = placement
        lay, k = placement.layout, len(placement.held)
        self.leaves = [[lay.leaves(b) for b in per] for per in blocks]
        dev = self.leaves[0][0][0].device
        self.anchor = torch.zeros((), device=dev, requires_grad=grad)
        self.sink = []
        for i in range(len(blocks)):
            if not grad:
                self.sink.append([None] * len(self.leaves[i][0]))
                continue
            row = []
            for j, leaf in enumerate(self.leaves[i][0]):
                if i and placement.whole[j]:
                    row.append(self.sink[0][j])
                    continue
                shape, d = list(leaf.shape), placement.dims[j]
                if d is not None:
                    shape[d] *= k
                row.append(torch.zeros(shape, dtype=torch.float32,
                                       device=dev))
            self.sink.append(row)
        self.top = tuple(dict.fromkeys(p[0] for p in lay.paths))
        self._units: dict[str, list] = {}

    def _use(self, i: int, j: int, r: int | None = None) -> torch.Tensor:
        parts = [ls[j] for ls in self.leaves[i]]
        sink, d = self.sink[i][j], self.p.dims[j]
        if r is not None:
            parts = [x[r] for x in parts]
            sink = None if sink is None else sink[r]
            d = None if d is None else d - 1
        if d is None:
            parts = parts[:1]
        return _Use.apply(self.p.world, d, sink, self.anchor, *parts)

    def _gather(self, js: list[int], r: int | None = None) -> list:
        got: list[list] = []
        for i in range(len(self.leaves)):
            got.append([got[0][n] if i and self.p.whole[j]
                        else self._use(i, j, r) for n, j in enumerate(js)])
        paths = [self.p.layout.paths[j] for j in js]
        return [path_unflatten(paths, g) for g in got]

    def unit(self, name: str) -> list:
        """Top-level module ``name`` of each held model shard, gathered
        on the first call of the microstep."""
        if name not in self._units:
            js = [j for j, p in enumerate(self.p.layout.paths)
                  if p[0] == name]
            self._units[name] = [t[name] for t in self._gather(js)]
        return self._units[name]

    def repeat(self, r: int) -> list:
        """Repeat ``r`` of ``blocks`` of each held model shard, gathered
        anew at each call."""
        js = [j for j, p in enumerate(self.p.layout.paths)
              if p[0] == "blocks"]
        return [t["blocks"] for t in self._gather(js, r)]

    def whole(self) -> Any:
        """The first held model shard's tree, every leaf gathered whole
        (``blocks`` stacked): for a loss that is not the LM's."""
        return self._gather(list(range(len(self.p.layout.paths))))[0]

    def views(self) -> list:
        """Each held model shard's :class:`Top`."""
        return [Top(self, i) for i in range(len(self.leaves))]


def placement_of(shapes: Any, specs: Any, mesh, world) -> Placement:
    """The :class:`Placement` of a whole tree of ``shapes`` (anything with
    ``.shape`` and ``.dtype``) by its rule tables' ``specs`` on ``mesh``,
    W = the ``data`` axis's size: the layout over one model shard's tree
    (its leaves' shapes and dtypes; the flat state of the fused step is
    not made), for the steps that hold the params as blocks without it:
    the placed serving steps and the placed pytree step."""
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), shapes)
    w = mesh.shape["data"] if "data" in mesh.axis_names else 1
    layout = ShardedFlatLayout.from_params(S.place(meta, specs, mesh, 0), w)
    return Placement.of(layout, specs, mesh, world)


def serving_view(placement: Placement, blocks: list) -> list:
    """Each held model shard's :class:`Top` over the held ``blocks`` for a
    serving step, under ``torch.no_grad``: each top-level module gathered
    over ``data`` on its first use in the step and each repeat of
    ``blocks`` at each use, nothing kept between repeats, no gradient
    sinks.  Where the rules leave every weight whole over ``data``
    (``sharding.serve_param_specs``) nothing gathers."""
    return Microstep(placement, blocks, grad=False).views()


def grad_rows(p: Placement, step: Microstep, i: int, j: int, di: int
              ) -> torch.Tensor:
    """The float32 gradient of leaf ``j`` for held model shard ``i``'s
    ``di``-th held data block after the microstep's backward, reduced
    over ``data``: its rows of the sink; for a leaf whole over ``data``
    the ranks' partials summed (``world.data_sum``), the whole leaf."""
    g, d = step.sink[i][j], p.dims[j]
    if d is None:
        return p.world.data_sum(g)
    return g.narrow(d, di * p.rows[j], p.rows[j])


class Top:
    """Held model shard ``i``'s tree as the model code reads it: a
    top-level module gathered on first use (:meth:`Microstep.unit`),
    ``blocks`` a :class:`Stack`."""

    def __init__(self, step: Microstep, i: int):
        self.step, self.i = step, i

    def __getitem__(self, name: str) -> Any:
        if name == "blocks":
            return Stack(self.step, self.i)
        if name not in self.step.top:
            raise KeyError(name)
        return self.step.unit(name)[self.i]

    def __contains__(self, name: str) -> bool:
        return name in self.step.top


class Stack:
    """Held model shard ``i``'s ``blocks``, gathered a repeat at a time
    (:func:`repeat`)."""

    def __init__(self, step: Microstep, i: int):
        self.step, self.i = step, i


def held(blocks: Any) -> bool:
    """Whether ``blocks`` (a tree, a :class:`Stack`, or a list of either,
    one a held model shard) are FSDP-held."""
    return isinstance(blocks[0] if isinstance(blocks, list) else blocks,
                      Stack)


def repeat(blocks: Any, r: int) -> Any:
    """Repeat ``r`` of held ``blocks`` (a :class:`Stack`, or a list of
    them under a model axis), gathered once for every held model
    shard."""
    stacks = blocks if isinstance(blocks, list) else [blocks]
    got = stacks[0].step.repeat(r)
    out = [got[s.i] for s in stacks]
    return out if isinstance(blocks, list) else out[0]


# the re-layouts' window: float32 elements of the (W, c) block that one
# collective carries, c columns of every data shard's part of a layer
# group (read at each call)
WINDOW = 1 << 26


def _slabs(p: Placement, g: int) -> list[tuple]:
    """The slabs of layer group ``g`` in layout order: ``(j, r, start,
    n)``, one a leaf, or one a repeat of a leaf stacked over ``blocks`` or
    the ``encoder`` (``r`` its index, else None), ``start`` its first
    element in the group's flat and ``n`` its elements."""
    lay, out = p.layout, []
    for j in lay.group_leaves(g):
        o, n = lay.offsets[j], lay.sizes[j]
        if lay.paths[j][0] in ("blocks", "encoder"):
            per = n // lay.shapes[j][0]
            out += [(j, r, o + r * per, per)
                    for r in range(lay.shapes[j][0])]
        else:
            out.append((j, None, o, n))
    return out


def _slab_dim(p: Placement, j: int, r: int | None) -> int | None:
    """The ``data`` dimension of slab ``(j, r)``: the leaf's, less the
    stacked dimension for a repeat."""
    d = p.dims[j]
    return d if d is None or r is None else d - 1


def _windows(p: Placement, g: int):
    """``(c0, c1, pieces)`` for each window of layer group ``g``: columns
    ``c0:c1`` of every data shard's part of the group, and for each data
    shard ``s`` and slab ``(j, r, start, n)`` that meets it, ``(s, slab,
    x0, x1)``: the slab's elements ``x0:x1`` sit at the window's row ``s``
    from column ``x0 + start - s * gsn - c0``.  Also, with each window,
    the slabs that no later window meets."""
    lay = p.layout
    w = lay.num_shards
    a, b = lay.group_shard_bounds(g)
    gsn = b - a
    c = max(1, min(gsn, WINDOW // w))
    slabs = _slabs(p, g)
    last = {}
    for sl in slabs:
        _, _, start, n = sl
        s0, s1 = start // gsn, (start + n - 1) // gsn
        last[sl[:2]] = gsn if s1 > s0 else start + n - s0 * gsn
    for c0 in range(0, gsn, c):
        c1 = min(c0 + c, gsn)
        pieces = []
        for s in range(w):
            lo, hi = s * gsn + c0, s * gsn + c1
            for sl in slabs:
                _, _, start, n = sl
                x0, x1 = max(lo, start), min(hi, start + n)
                if x0 < x1:
                    pieces.append((s, sl, x0 - start, x1 - start))
        done = [sl[:2] for sl in slabs if c0 < last[sl[:2]] <= c1]
        yield c0, c1, pieces, done


def _own(p: Placement, j: int, r: int | None, rows) -> torch.Tensor:
    """Slab ``(j, r)`` whole, float32, flat: ``rows`` (the held data
    shards' rows of it, one tensor) at their place and ``-0.0`` at the
    other ranks' rows; ``rows`` itself where this process holds every
    row or the leaf is whole over ``data``."""
    d, k, lay = _slab_dim(p, j, r), len(p.held), p.layout
    if d is None or k == lay.num_shards:
        return rows.float().reshape(-1)
    shape = list(lay.shapes[j][1:] if r is not None else lay.shapes[j])
    full = torch.full(shape, -0.0, dtype=torch.float32, device=rows.device)
    full.narrow(d, p.held[0] * p.rows[j], k * p.rows[j]).copy_(rows)
    return full.view(-1)


def _to_columns(p: Placement, out: torch.Tensor, rows_of, partial: bool
                ) -> None:
    """Rows to columns, a window of a layer group at a time: each window
    filled with this process's values (``rows_of(j, r)``, the held rows of
    slab ``(j, r)``, ``-0.0`` at the other ranks' rows), then
    reduce-scattered over the data ranks into ``out``, the ``(k_d,
    shard_size)`` columns of the held data shards.  A leaf whole over
    ``data`` gives its ``partial`` to every column (summed over the ranks)
    or, without ``partial`` (the params, the same on every rank), to the
    held columns alone."""
    lay, k = p.layout, len(p.held)
    w = lay.num_shards
    for g in range(lay.num_groups):
        a, _ = lay.group_shard_bounds(g)
        slabs: dict = {}
        for c0, c1, pieces, done in _windows(p, g):
            vec = torch.zeros((w, c1 - c0), dtype=torch.float32,
                              device=out.device)
            for s, (j, r, start, _), x0, x1 in pieces:
                if (j, r) not in slabs:
                    slabs[(j, r)] = _own(p, j, r, rows_of(j, r))
                col = x0 + start - s * lay.group_shard_sizes[g] - c0
                dst = vec[s, col:col + x1 - x0]
                if p.dims[j] is None and not partial \
                        and s not in p.held and p.world.size > 1:
                    dst.fill_(-0.0)
                else:
                    dst.copy_(slabs[(j, r)][x0:x1])
            for key in done:
                slabs.pop(key, None)
            got = p.world.reduce_scatter(vec.view(-1))
            out[:, a + c0:a + c1].copy_(got.view(k, c1 - c0))


def push(p: Placement, sink: list, out: torch.Tensor) -> None:
    """One held model shard's gradient, rows to columns: ``sink`` (its
    :class:`Microstep` row) into ``out``, the ``(k_d, shard_size)``
    columns of its held data shards, a window at a time: the held rows
    (``-0.0`` at the other ranks' rows) and the whole-over-data leaves'
    partials, reduce-scattered over the data ranks."""
    _to_columns(p, out, lambda j, r: sink[j] if r is None else sink[j][r],
                True)


def columns(p: Placement, leaves: list, out: torch.Tensor) -> None:
    """One held model shard's params, rows to columns: ``leaves`` (its
    held blocks' leaf lists, in data shard order) into ``out``, the
    ``(k_d * shard_size,)`` float32 run of its held data shards' columns,
    a window at a time, each column from the one rank that holds it
    (``-0.0`` from the others) and zero padding."""
    def rows_of(j, r):
        parts = [ls[j] if r is None else ls[j][r] for ls in leaves]
        d = _slab_dim(p, j, r)
        if d is None or len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=d)

    _to_columns(p, out.view(len(p.held), p.layout.shard_size), rows_of,
                False)


def rows(p: Placement, run: torch.Tensor, leaves: list) -> None:
    """One held model shard's params, columns to rows, in place: the
    held blocks' ``leaves`` (in data shard order) cut from the updated
    ``(k_d * shard_size,)`` float32 ``run``, a window at a time (the
    window's columns gathered over the data ranks into the slabs they
    fill; a slab, once whole, cut into its held rows, each cast to its
    leaf's dtype)."""
    lay, k = p.layout, len(p.held)
    cols = run.view(k, lay.shard_size)
    for g in range(lay.num_groups):
        a, _ = lay.group_shard_bounds(g)
        gsn = lay.group_shard_sizes[g]
        staged: dict = {}
        for c0, c1, pieces, done in _windows(p, g):
            vec = p.world.gather_flat(
                cols[:, a + c0:a + c1].reshape(-1)).view(-1, c1 - c0)
            for s, (j, r, start, n), x0, x1 in pieces:
                if (j, r) not in staged:
                    staged[(j, r)] = torch.empty(
                        (n,), dtype=torch.float32, device=run.device)
                col = x0 + start - s * gsn - c0
                staged[(j, r)][x0:x1].copy_(vec[s, col:col + x1 - x0])
            for j, r in done:
                whole = staged.pop((j, r)).view(
                    lay.shapes[j][1:] if r is not None else lay.shapes[j])
                d = _slab_dim(p, j, r)
                for di, ls in enumerate(leaves):
                    dst = ls[j] if r is None else ls[j][r]
                    dst.copy_(whole if d is None else whole.narrow(
                        d, (p.held[0] + di) * p.rows[j], p.rows[j]))


def transient_bytes(p: Placement) -> int:
    """A bound on the float32 bytes a re-layout holds at once beyond its
    input and output, over the layer groups: the (W, c) window, the slabs
    that lie inside it (at most as many elements again), and the slabs
    that cross its edges (at most 2 W - 1, each no larger than the
    group's largest slab)."""
    lay = p.layout
    w = lay.num_shards
    most = 0
    for g in range(lay.num_groups):
        gsn = lay.group_shard_sizes[g]
        sizes = [n for *_, n in _slabs(p, g)]
        most = max(most, 2 * w * max(1, min(gsn, WINDOW // w))
                   + min(len(sizes), 2 * w - 1) * max(sizes))
    return 4 * most


def gather(p: Placement, blocks: list) -> list:
    """Each held model shard's tree whole over ``data`` from its held
    ``blocks``: each leaf split over ``data`` gathered over the data ranks
    (``world.data_gather``, so every rank of the data subgroup calls it),
    each other leaf the first block's."""
    lay, out = p.layout, []
    for per in blocks:
        leaves = [lay.leaves(b) for b in per]
        out.append(lay.unflatten([
            leaves[0][j] if d is None else p.world.data_gather(
                [ls[j] for ls in leaves], d)
            for j, d in enumerate(p.dims)]))
    return out


def held_bytes(blocks: list) -> int:
    """The bytes of every leaf of the held ``blocks``."""
    return sum(x.numel() * x.element_size() for per in blocks
               for b in per for x in _leaves(b))


def largest_gather(p: Placement) -> tuple[str, int]:
    """The largest gather of a microstep's forward, for one model shard:
    (its name, its bytes whole over ``data``): a top-level module once, or
    one repeat of ``blocks``."""
    lay, sizes = p.layout, {}
    for path, shape, dt in zip(lay.paths, lay.shapes, lay.dtypes):
        n = torch.Size(shape[1:] if path[0] == "blocks" else shape).numel()
        key = "blocks (one repeat)" if path[0] == "blocks" else path[0]
        sizes[key] = sizes.get(key, 0) + n * dt.itemsize
    return max(sizes.items(), key=lambda kv: kv[1])


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]

