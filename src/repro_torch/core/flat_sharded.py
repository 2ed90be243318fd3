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
``(M, shard_size)`` buffer, one launch per shard.  The reference's sharded
buffer push (``sharded_flat_push_and_maybe_apply``,
``init_sharded_flat_buffer``) and its per-leaf oracle are not ported
(ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from repro_torch.core.gba import (Params, path_leaves, path_unflatten,
                                  tree_paths)
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

    def unravel_group(self, g: int, group_flat: torch.Tensor,
                      dtype: torch.dtype | None = None) -> list:
        """Contiguous group flat -> that group's leaves, each cast to
        ``dtype`` or, by default, to its own dtype, into storage of its
        own."""
        return [group_flat[self.offsets[j]:self.offsets[j] + self.sizes[j]]
                .reshape(self.shapes[j]).to(dtype or self.dtypes[j],
                                            copy=True)
                for j in self.group_leaves(g)]

    def unravel_groups(self, group_flats: Iterable[torch.Tensor],
                       dtype: torch.dtype | None = None) -> Params:
        """Per-group contiguous flats, in group order -> the whole tree,
        each leaf cast as :meth:`unravel_group` casts it.  A generator is
        consumed one group at a time, so only one group's flat need be
        alive."""
        leaves: list = [None] * len(self.sizes)
        for g, gflat in enumerate(group_flats):
            for j, leaf in zip(self.group_leaves(g),
                               self.unravel_group(g, gflat, dtype)):
                leaves[j] = leaf
        return self.unflatten(leaves)

    def ravel(self, tree: Params, pad: float = 0.0) -> torch.Tensor:
        """Tree -> a new (padded_total,) float32 in shard-major group
        order: shard ``s``'s slice is the concatenation of every group's
        ``s``-th sub-slice.  Padding is ``pad``, zero by default."""
        leaves = self.leaves(tree)
        flat = torch.empty((self.padded_total,), dtype=torch.float32,
                           device=leaves[0].device)
        rows = flat.view(self.num_shards, self.shard_size)
        for g in range(self.num_groups):
            lo, hi = self.group_shard_bounds(g)
            rows[:, lo:hi].copy_(
                self.ravel_group(g, leaves, pad).view(self.num_shards, -1))
        return flat

    def unravel(self, flat: torch.Tensor,
                dtype: torch.dtype | None = None) -> Params:
        """The tree of a shard-major ``(padded_total,)`` vector, each leaf
        in storage of its own, cast to ``dtype`` or, by default, to its
        own dtype (the reference's ``unravel(flat, dtype)``: an Adagrad
        accumulator stays float32 for a bfloat16 model).  Group ``g``'s
        contiguous flat is column slice ``g`` of every shard's row, which
        is what a tiled ``all_gather`` of the shards' sub-slices gives."""
        rows = flat.view(self.num_shards, self.shard_size)
        return self.unravel_groups(
            (rows[:, lo:hi].reshape(-1)
             for lo, hi in map(self.group_shard_bounds,
                               range(self.num_groups))), dtype)

    def shard_bounds(self, s: int) -> tuple[int, int]:
        """[start, stop) of shard ``s``'s flat slice."""
        if not 0 <= s < self.num_shards:
            raise IndexError(s)
        return s * self.shard_size, (s + 1) * self.shard_size


def make_sharded_apply(layout: ShardedFlatLayout, *, iota: int) -> Callable:
    """The per-shard single-launch apply: ``apply(param_flat, accum_flat,
    shard_buffers, tokens, step, lr)`` runs ``gba_apply`` (token-decay
    aggregate and Adagrad) on shard ``s``'s contiguous ``param_flat`` and
    ``accum_flat`` slices with the ``s``-th ``(M, shard_size)`` buffer of
    ``shard_buffers``, one launch per shard, in place, and returns
    ``(param_flat, accum_flat)``.  ``shard_buffers`` may be a generator
    that fills one buffer shard after shard; every shard sees the same
    ``tokens`` (M,) int32 and ``step``."""

    def apply_shards(param_flat: torch.Tensor, accum_flat: torch.Tensor,
                     shard_buffers: Iterable[torch.Tensor],
                     tokens: torch.Tensor, step: int, lr: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        applied = 0
        for s, buf in enumerate(shard_buffers):
            lo, hi = layout.shard_bounds(s)
            ops.gba_apply_flat(param_flat[lo:hi], accum_flat[lo:hi], buf,
                               tokens, step, lr, iota=iota)
            applied += 1
        if applied != layout.num_shards:
            raise ValueError(f"{applied} shard buffers for "
                             f"{layout.num_shards} shards")
        return param_flat, accum_flat

    return apply_shards
