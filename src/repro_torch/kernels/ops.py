"""Public wrappers over the kernels, with the wrapper census.

Counterpart of ``repro.kernels.ops`` for the kernels ported so far.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_grad)

# Python-level invocation census of the wrappers below, as in the JAX
# package: a hot-ID cache hit must leave ``kernel_calls["pooled_lookup"]``
# unchanged, because the batch never reached the lookup kernel.  It counts
# wrapper invocations on any device; ``embedding_bag.launches`` and
# ``embedding_bag_grad.launches`` count the CUDA launches alone.
kernel_calls: collections.Counter = collections.Counter()


def pooled_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum-pooled lookup (B, F) x (V, D) -> (B, D) through the
    ``embedding_bag`` kernel."""
    kernel_calls["pooled_lookup"] += 1
    return embedding_bag(ids, table)


def pooled_lookup_grad(ids: torch.Tensor, grad_out: torch.Tensor,
                       capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted scatter of (B, D) gradient rows into a (capacity, D) table
    gradient with per-id contributor counts, through the
    ``embedding_bag_grad`` kernel."""
    kernel_calls["pooled_lookup_grad"] += 1
    return embedding_bag_grad(ids, grad_out, capacity)
