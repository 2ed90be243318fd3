"""Hashing-trick embedding tables with per-ID update-step tracking.

Counterpart of ``repro.embeddings.table`` for the serving path: raw
categorical IDs are hashed into a fixed-capacity table, and each row
carries the global step of its last update (``last_update``).  The
training half of that module (the differentiable pooled lookup, presence
counts and the sparse apply) is not ported yet.  The JAX module's
``StreamConfig`` sized TPU VMEM blocks and has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
