"""Plain PyTorch versions of the kernels.

The CPU tests hold them against the JAX package, the wrappers use them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) int ids, (V, D) table -> (B, D) sum-pool in the table's dtype,
    accumulated in float32.

    Follows the kernel's contract, not JAX indexing: every id outside
    ``[0, V)`` (negative ids, the padding sentinel ``V``) contributes a zero
    row.  ``repro.kernels.ref.embedding_bag_ref`` instead wraps negative ids
    and clamps large ones, so the two agree on in-range ids only."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0).long()].float()    # (B, F, D)
    rows = torch.where(valid[..., None], rows, 0.0)
    return rows.sum(dim=1, dtype=torch.float32).to(table.dtype)
