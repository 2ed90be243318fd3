"""Hashing-trick embedding tables with per-ID update-step tracking.

Counterpart of ``repro.embeddings.table``: raw categorical IDs are hashed
into a fixed-capacity table, and each row carries the global step of its
last update (``last_update``).  :func:`pooled_lookup` is the differentiable
sum-pooled lookup, whose forward and backward are the ``embedding_bag`` and
``embedding_bag_grad`` kernels; :func:`presence_counts` is the backward
kernel's counts output, which the replay trainer takes as Alg. 2's
per-slot contributor counts.  The JAX module's ``StreamConfig`` sized TPU
VMEM blocks and has no counterpart here; its ``sparse_grads_to_dense`` and
``apply_sparse_grads`` have no caller on a ported path and are not ported
yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device

# Knuth multiplicative hashing: spreads raw categorical IDs over the table.
_HASH_MULT = 2654435761
_HASH_LO, _HASH_HI = _HASH_MULT & 0xFFFF, _HASH_MULT >> 16
_U32 = 0xFFFFFFFF


class EmbeddingTable(NamedTuple):
    table: torch.Tensor        # (capacity, dim)
    last_update: torch.Tensor  # (capacity,) int32: global step of last update


def init_table(capacity: int, dim: int, scale: float = 0.01, *,
               generator: torch.Generator,
               device: str | torch.device = "cuda") -> EmbeddingTable:
    """Normal(0, ``scale``) rows drawn on the CPU from ``generator`` (so a
    seed gives the same table on every device), then moved to ``device``."""
    dev = resolve_device(device)
    table = torch.randn((capacity, dim), generator=generator,
                        dtype=torch.float32) * scale
    return EmbeddingTable(
        table=table.to(dev),
        last_update=torch.zeros((capacity,), dtype=torch.int32, device=dev))


def hash_ids(raw_ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Raw ids -> int32 rows in ``[0, capacity)``, equal to the JAX
    package's ``hash_ids`` after its int32 cast.

    The ids are cast to int32 (a wider id wraps), read as uint32, multiplied
    by the Knuth constant mod 2^32 and shifted right by 8.  The uint32
    product is built from two 16-bit halves of the constant so that no
    int64 intermediate overflows."""
    x = raw_ids.to(torch.int32).to(torch.int64) & _U32
    prod = (x * _HASH_LO + (((x * _HASH_HI) & 0xFFFF) << 16)) & _U32
    return ((prod >> 8) % capacity).to(torch.int32)


def lookup(tbl: EmbeddingTable, hashed_ids: torch.Tensor) -> torch.Tensor:
    """hashed_ids: (...,) in ``[0, capacity)`` -> (..., dim)."""
    return tbl.table[hashed_ids.long()]


class _PooledBag(torch.autograd.Function):
    """Sum-pooled lookup with the kernels in both directions.  The backward
    is the un-normalised scatter of the incoming gradient rows, cast to the
    table's dtype, and no gradient for the ids (``_pooled_bag_bwd`` of the
    JAX package); the per-id counts the kernel co-produces belong to
    Alg. 2's aggregation, not to autodiff, and are dropped here."""

    @staticmethod
    def forward(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return ops.pooled_lookup(ids, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids = inputs
        ctx.save_for_backward(ids)
        ctx.capacity, ctx.dtype = table.shape[0], table.dtype

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        gtable, _ = ops.pooled_lookup_grad(ids, grad.float().contiguous(),
                                           ctx.capacity)
        return gtable.to(ctx.dtype), None


def pooled_lookup(tbl: EmbeddingTable, hashed_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Differentiable sum-pooled lookup: (B, F) int32 -> (B, dim), through
    the ``embedding_bag`` kernel forward and ``embedding_bag_grad``
    backward."""
    return _PooledBag.apply(tbl.table, hashed_ids)


def presence_counts(hashed_ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per-id occurrence counts of a batch of hashed ids: (...,) int32 ->
    (capacity,) float32, the ``embedding_bag_grad`` kernel's counts output
    for the ids as one bag.  The gradient row has width 0, so on a CUDA
    device the wrapper launches a counts kernel on the raw ids, with no
    sort (counts are integers, the same in any order).  Ids outside ``[0,
    capacity)`` are not counted."""
    ids2d = hashed_ids.reshape(1, -1)
    no_rows = torch.zeros((1, 0), dtype=torch.float32,
                          device=hashed_ids.device)
    _, counts = ops.pooled_lookup_grad(ids2d, no_rows, capacity)
    return counts
