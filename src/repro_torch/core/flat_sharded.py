"""Sharding-aware flat layout of GBA's PS step: one ``gba_apply`` launch
per PS shard.

Counterpart of ``repro.core.flat_sharded``.  :class:`ShardedFlatLayout`
lays the dense parameter tree's leaves back to back like
``repro_torch.core.gba.FlatLayout``, but pads every leaf to a ``tile``
multiple and the total so that it splits into ``num_shards`` equal,
tile-aligned, contiguous slices: shard ``s`` owns ``flat[s * shard_size :
(s + 1) * shard_size]``.

With ``group_by`` the layout is also layer-grouped: each leaf goes to the
group its path names, each group's flat extent splits into ``num_shards``
equal tile-aligned sub-slices, and the global order is shard-major, so
shard ``s``'s slice is the concatenation of every group's ``s``-th
sub-slice.  A worker then gathers and routes one group at a time while a
shard's slice stays one contiguous run for its apply.  ``group_by=None``
is one group, ``"all"``, covering everything.

:func:`make_sharded_apply` runs ``gba_apply`` on each shard's contiguous
``(M, shard_size)`` buffer, one launch per shard.
:func:`init_sharded_flat_buffer` and
:func:`sharded_flat_push_and_maybe_apply` are the sharded counterparts of
``repro_torch.core.gba``'s flat buffer: the M-slot buffer is stored
shard-major, ``(shards, M, shard_size)``, so each shard's ``(M,
shard_size)`` block is one contiguous run for its launch, and is handed
out as its ``(M, shards, shard_size)`` transpose, so slot ``j`` is
``grads[j]`` as in the reference's ``(M, padded_total)`` buffer.  A
process may hold a run of consecutive shards rather than all of them (a
``torch.distributed`` rank holds k of W): its buffer has those k shards'
blocks, and its pushes and applies take its ``(k * shard_size,)`` run.
:func:`per_leaf_kernel_apply` is the per-leaf launch chain the sharded
apply replaces, its bit-exactness oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from repro_torch.core.gba import (Params, flat_buffer_push, path_leaves,
                                  path_unflatten, tree_paths)
from repro_torch.kernels import ops

# the tile every leaf and shard is aligned to: the reference's ``BLOCK_N``,
# the column block of the TPU ``gba_apply`` kernel
TILE = 2048

GroupBy = Callable[[tuple[str, ...]], str]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclass(frozen=True)
class ShardedFlatLayout:
    """Leaf-aligned, tile-aligned flat layout split into PS shard slices.

    Leaf ``j`` (in ``jax.tree.flatten`` order, the reference's) starts at
    ``offsets[j]``, a ``tile`` multiple, *within its layer group's
    contiguous flat*, and spans ``padded_sizes[j]`` elements, zero past
    ``sizes[j]``.  Group ``g`` spans ``group_sizes[g]`` elements (a
    ``num_shards * tile`` multiple), of which shard ``s`` owns the ``s``-th
    ``group_shard_sizes[g]``-wide sub-slice, at column
    ``group_local_offsets[g]`` of its slice.  ``padded_total == num_shards
    * shard_size`` and ``shard_size % tile == 0``.  ``paths`` takes the
    place of the reference's ``treedef``."""

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    padded_sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    total: int            # sum of true leaf sizes (FlatLayout's total)
    padded_total: int     # num_shards * shard_size
    num_shards: int
    shard_size: int
    tile: int
    group_keys: tuple[str, ...]         # group names, in layout order
    leaf_group: tuple[int, ...]         # group index per leaf
    group_sizes: tuple[int, ...]        # padded flat extent per group
    group_shard_sizes: tuple[int, ...]  # = group_sizes[g] // num_shards
    group_local_offsets: tuple[int, ...]  # column of group g in a shard

    @classmethod
    def from_params(cls, params: Params, num_shards: int, tile: int = TILE,
                    group_by: GroupBy | None = None) -> "ShardedFlatLayout":
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if tile < 1:
            raise ValueError(f"tile must be >= 1, got {tile}")
        paths, leaves = zip(*tree_paths(params))
        shapes = tuple(tuple(x.shape) for x in leaves)
        sizes = tuple(math.prod(s) for s in shapes)
        padded_sizes = tuple(_round_up(s, tile) for s in sizes)
        keys = (["all"] * len(leaves) if group_by is None
                else [str(group_by(p)) for p in paths])
        group_keys: list[str] = []
        leaf_group: list[int] = []
        for k in keys:                       # group order = first appearance
            if k not in group_keys:
                group_keys.append(k)
            leaf_group.append(group_keys.index(k))
        offsets, cursor = [], [0] * len(group_keys)
        for j, g in enumerate(leaf_group):
            offsets.append(cursor[g])
            cursor[g] += padded_sizes[j]
        chunk = num_shards * tile
        group_sizes = tuple(_round_up(max(c, tile), chunk) for c in cursor)
        group_shard_sizes = tuple(gs // num_shards for gs in group_sizes)
        group_local_offsets, col = [], 0
        for gsn in group_shard_sizes:
            group_local_offsets.append(col)
            col += gsn
        return cls(tuple(paths), shapes, tuple(x.dtype for x in leaves),
                   sizes, padded_sizes, tuple(offsets), sum(sizes),
                   num_shards * col, num_shards, col, tile,
                   tuple(group_keys), tuple(leaf_group), group_sizes,
                   group_shard_sizes, tuple(group_local_offsets))

    @property
    def num_groups(self) -> int:
        return len(self.group_keys)

    @property
    def peak_gather_bytes(self) -> int:
        """Peak live gathered bytes a worker holds under the layer-grouped
        schedule: the largest group's float32 extent."""
        return max(self.group_sizes) * 4

    @property
    def full_gather_bytes(self) -> int:
        """Gathered bytes of the ungrouped schedule: the whole vector."""
        return self.padded_total * 4

    def group_table(self, compress=None) -> list[dict]:
        """One row per group, for logs: ``key``, ``elements``, ``bytes``
        (float32), ``leaves``, and the group's routed ``wire_bytes`` and
        ``wire_dtype`` under the ``CompressionPolicy`` ``compress``, or
        the float32 routing without one."""
        rows = []
        for g, k in enumerate(self.group_keys):
            row = {"key": k, "elements": self.group_sizes[g],
                   "bytes": self.group_sizes[g] * 4,
                   "leaves": len(self.group_leaves(g))}
            if compress is None:
                row["wire_bytes"], row["wire_dtype"] = row["bytes"], "float32"
            else:
                row["wire_bytes"] = compress.route_bytes(self.group_sizes[g],
                                                         self.tile)
                row["wire_dtype"] = compress.wire_dtype()
            rows.append(row)
        return rows

    def wire_state_shapes(self, m: int, scheme: str) -> dict:
        """Shapes of the per-worker wire state of ``scheme``: one ``(m,
        padded_total)`` float32 row per worker for the residual (int8,
        onebit) and the momentum (onebit)."""
        names = {"none": (), "int8": ("residual",),
                 "onebit": ("residual", "momentum")}
        if scheme not in names:
            raise ValueError(f"unknown compression scheme {scheme!r}")
        return {name: (m, self.padded_total) for name in names[scheme]}

    def leaves(self, tree: Params) -> list[torch.Tensor]:
        return path_leaves(self.paths, tree)

    def unflatten(self, leaves: list[torch.Tensor]) -> Params:
        return path_unflatten(self.paths, leaves)

    def group_shard_bounds(self, g: int) -> tuple[int, int]:
        """[start, stop) columns of group ``g`` within one shard's
        ``(shard_size,)`` slice."""
        if not 0 <= g < self.num_groups:
            raise IndexError(g)
        lo = self.group_local_offsets[g]
        return lo, lo + self.group_shard_sizes[g]

    def group_leaves(self, g: int) -> tuple[int, ...]:
        """Leaf indices of group ``g``, in layout order."""
        return tuple(j for j, lg in enumerate(self.leaf_group) if lg == g)

    def ravel_group(self, g: int, leaves: list, pad: float = 0.0
                    ) -> torch.Tensor:
        """Group ``g``'s leaves (``leaves`` in layout order; the others
        are not read and may be ``None``) -> a new contiguous
        ``(group_sizes[g],)`` float32 on their device.  Padding is ``pad``,
        zero by default, so padding columns never carry gradient."""
        members = self.group_leaves(g)
        flat = torch.full((self.group_sizes[g],), pad, dtype=torch.float32,
                          device=leaves[members[0]].device)
        for j in members:
            o, n = self.offsets[j], self.sizes[j]
            flat[o:o + n].copy_(leaves[j].reshape(-1))
        return flat

    def _runs(self, g: int, start: int, stop: int):
        """``(shard, col, stop_col, first)`` for each shard's piece of
        ``[start, stop)`` of group ``g``'s flat: that shard's row holds
        group elements ``first ... first + stop_col - col - 1`` at columns
        ``col:stop_col``."""
        lo, hi = self.group_shard_bounds(g)
        gsn = hi - lo
        while start < stop:
            s, end = start // gsn, min(stop, (start // gsn + 1) * gsn)
            yield s, lo + start - s * gsn, lo + end - s * gsn, start
            start = end

    def ravel(self, tree: Params, pad: float = 0.0) -> torch.Tensor:
        """Tree -> a new (padded_total,) float32 in shard-major group
        order: shard ``s``'s slice is the concatenation of every group's
        ``s``-th sub-slice.  Padding is ``pad``, zero by default.  Each
        leaf is copied straight into its shards' columns."""
        leaves = self.leaves(tree)
        flat = torch.empty((self.padded_total,), dtype=torch.float32,
                           device=leaves[0].device)
        rows = flat.view(self.num_shards, self.shard_size)
        ends = [0] * self.num_groups
        for j, leaf in enumerate(leaves):
            g, o, n = self.leaf_group[j], self.offsets[j], self.sizes[j]
            src = leaf.reshape(-1)
            for s, c0, c1, a in self._runs(g, o, o + n):
                rows[s, c0:c1].copy_(src[a - o:a - o + c1 - c0])
            for s, c0, c1, _ in self._runs(g, o + n,
                                           o + self.padded_sizes[j]):
                rows[s, c0:c1].fill_(pad)
            ends[g] = o + self.padded_sizes[j]
        for g, end in enumerate(ends):
            for s, c0, c1, _ in self._runs(g, end, self.group_sizes[g]):
                rows[s, c0:c1].fill_(pad)
        return flat

    def unravel(self, flat: torch.Tensor,
                dtype: torch.dtype | None = None) -> Params:
        """The tree of a shard-major ``(padded_total,)`` vector, each leaf
        in storage of its own, cast to ``dtype`` or, by default, to its
        own dtype (the reference's ``unravel(flat, dtype)``: an Adagrad
        accumulator stays float32 for a bfloat16 model).  Each leaf is
        copied straight out of its shards' columns: what a tiled
        ``all_gather`` of the shards' slices holds."""
        rows = flat.view(self.num_shards, self.shard_size)
        leaves = []
        for j, shape in enumerate(self.shapes):
            g, o = self.leaf_group[j], self.offsets[j]
            leaf = torch.empty(shape, dtype=dtype or self.dtypes[j],
                               device=flat.device)
            dst = leaf.view(-1)
            for s, c0, c1, a in self._runs(g, o, o + self.sizes[j]):
                dst[a - o:a - o + c1 - c0].copy_(rows[s, c0:c1])
            leaves.append(leaf)
        return self.unflatten(leaves)

    def shard_bounds(self, s: int) -> tuple[int, int]:
        """[start, stop) of shard ``s``'s flat slice."""
        if not 0 <= s < self.num_shards:
            raise IndexError(s)
        return s * self.shard_size, (s + 1) * self.shard_size

    def leaves_in_shard(self, s: int) -> tuple[int, ...]:
        """Leaf indices whose padded extent overlaps shard ``s``: what a
        per-leaf chain would launch on that shard."""
        self.shard_bounds(s)
        out = []
        for j, (off, n) in enumerate(zip(self.offsets, self.padded_sizes)):
            gsn = self.group_shard_sizes[self.leaf_group[j]]
            # leaf j spans [off, off + n) of its group's flat, of which
            # shard s owns [s * gsn, (s + 1) * gsn)
            if off < (s + 1) * gsn and off + n > s * gsn:
                out.append(j)
        return tuple(out)


def init_sharded_flat_buffer(params: Params, buffer_size: int,
                             num_shards: int, tile: int = TILE,
                             group_by: GroupBy | None = None,
                             held: int | None = None
                             ) -> tuple[ShardedFlatLayout, dict]:
    """The sharded M-slot gradient buffer on the params' device for the
    ``held`` consecutive shards a process holds (all ``num_shards`` by
    default): ``grads`` the ``(M, held, shard_size)`` view of a
    shard-major ``(held, M, shard_size)`` float32 zeros (slot ``j`` is
    ``grads[j]``, the ``s``-th held shard's contiguous block
    ``grads[:, s]``), ``tokens`` (M,) int32 zeros, ``fill`` and ``step``
    0.  ``group_by`` makes the layout layer-grouped.  Returns (layout,
    buffer); the layout is the whole one, of every shard."""
    layout = ShardedFlatLayout.from_params(params, num_shards, tile,
                                           group_by=group_by)
    held = num_shards if held is None else held
    if not 1 <= held <= num_shards:
        raise ValueError(f"a process holds 1 to {num_shards} shards, not "
                         f"{held}")
    dev = layout.leaves(params)[0].device
    grads = torch.zeros((held, buffer_size, layout.shard_size),
                        dtype=torch.float32, device=dev)
    return layout, {
        "grads": grads.transpose(0, 1),
        "tokens": torch.zeros((buffer_size,), dtype=torch.int32, device=dev),
        "fill": 0,
        "step": 0,
    }


def sharded_flat_push(layout: ShardedFlatLayout, buffer: dict,
                      flat_grad: torch.Tensor, token: int
                      ) -> tuple[dict, bool]:
    """``flat_buffer_push`` of a shard-major gradient into the sharded
    buffer of :func:`init_sharded_flat_buffer`: ``flat_grad`` is the run
    of the shards the buffer holds (``(padded_total,)`` for all of them),
    and its ``s``-th ``shard_size`` row goes to the ``s``-th held shard's
    block."""
    rows = buffer["grads"].shape[1]
    if flat_grad.shape != (rows * layout.shard_size,):
        raise ValueError(f"a buffer of {rows} shards takes a "
                         f"({rows * layout.shard_size},) gradient, got "
                         f"{tuple(flat_grad.shape)}")
    return flat_buffer_push(
        buffer, flat_grad.view(rows, layout.shard_size), token)


def sharded_flat_push_and_maybe_apply(
        buffer: dict, flat_grad: torch.Tensor, token: int,
        param_flat: torch.Tensor, accum_flat: torch.Tensor, lr: float, *,
        layout: ShardedFlatLayout, iota: int):
    """Sharded counterpart of ``core.gba.flat_buffer_push_and_maybe_apply``:
    push one shard-major raveled gradient (the held shards' run); when the
    push fills the buffer, one ``gba_apply`` launch per held shard updates
    that shard's slice of ``param_flat`` and ``accum_flat`` (the same run)
    in place from its contiguous ``(M, shard_size)`` block, weighing each
    slot against the step before the push.  Returns ``(param_flat,
    accum_flat, applied, new_buffer)``; a push that does not fill the
    buffer leaves params and accumulator untouched."""
    new_buffer, is_full = sharded_flat_push(layout, buffer, flat_grad, token)
    if is_full:
        make_sharded_apply(layout, iota=iota)(
            param_flat, accum_flat, new_buffer["grads"].unbind(1),
            new_buffer["tokens"], buffer["step"], lr)
    return param_flat, accum_flat, is_full, new_buffer


def per_leaf_kernel_apply(layout: ShardedFlatLayout,
                          param_flat: torch.Tensor, accum_flat: torch.Tensor,
                          grads: torch.Tensor, tokens: torch.Tensor,
                          step: int, lr: float, *, iota: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-leaf launch chain the sharded apply replaces: one
    ``gba_apply`` launch per leaf (``len(layout.sizes)`` launches against
    one per shard), in place on each leaf's slice of ``param_flat`` and
    ``accum_flat``, from its ``(M, size)`` columns of ``grads`` ((M,
    padded_total) or the sharded buffer), copied contiguous.  The same
    arithmetic per element, so it is the sharded apply's bit-exactness
    oracle.  Single-group layouts only: a layer-grouped layout interleaves
    the leaves shard-major, so no leaf is one contiguous run."""
    if layout.num_groups > 1:
        raise ValueError(
            "per_leaf_kernel_apply requires a single-group layout; "
            f"got {layout.num_groups} groups {layout.group_keys}")
    grads = grads.reshape(grads.shape[0], layout.padded_total)
    for off, size in zip(layout.offsets, layout.sizes):
        ops.gba_apply_flat(param_flat[off:off + size],
                           accum_flat[off:off + size],
                           grads[:, off:off + size].contiguous(), tokens,
                           step, lr, iota=iota)
    return param_flat, accum_flat


def make_sharded_apply(layout: ShardedFlatLayout, *, iota: int) -> Callable:
    """The per-shard single-launch apply: ``apply(param_flat, accum_flat,
    shard_buffers, tokens, step, lr)`` runs ``gba_apply`` (token-decay
    aggregate and Adagrad) on the ``s``-th contiguous ``shard_size`` slice
    of ``param_flat`` and ``accum_flat`` with the ``s``-th ``(M,
    shard_size)`` buffer of ``shard_buffers``, one launch per shard, in
    place, and returns ``(param_flat, accum_flat)``.  The vectors hold
    every shard (``(padded_total,)``) or a run of consecutive shards, the
    ones a process holds.  ``shard_buffers`` may be a generator that fills
    one buffer shard after shard; every shard sees the same ``tokens``
    (M,) int32 and ``step``."""
    ss = layout.shard_size

    def apply_shards(param_flat: torch.Tensor, accum_flat: torch.Tensor,
                     shard_buffers: Iterable[torch.Tensor],
                     tokens: torch.Tensor, step: int, lr: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        shards, applied = param_flat.shape[0] // ss, 0
        if shards * ss != param_flat.shape[0]:
            raise ValueError(f"a {param_flat.shape[0]}-element vector is no "
                             f"whole number of {ss}-element shards")
        for s, buf in enumerate(shard_buffers):
            if s == shards:
                raise ValueError(f"more shard buffers than {shards} shards")
            ops.gba_apply_flat(param_flat[s * ss:(s + 1) * ss],
                               accum_flat[s * ss:(s + 1) * ss], buf,
                               tokens, step, lr, iota=iota)
            applied += 1
        if applied != shards:
            raise ValueError(f"{applied} shard buffers for {shards} shards")
        return param_flat, accum_flat

    return apply_shards
