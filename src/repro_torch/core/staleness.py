"""Staleness decay over the token index (paper Eq. (1)).

Counterpart of ``repro.core.staleness``.  Only the paper's hard threshold
is ported: it is what the worker-parallel step weighs its loss with.  The
reference's exponential and linear variants and ``DECAY_FNS`` have no
ported caller yet (ROADMAP.md).
"""
from __future__ import annotations

import torch


def threshold_decay(tokens: torch.Tensor, global_step: int,
                    iota: int) -> torch.Tensor:
    """Eq. (1): weight 0 where ``global_step - token > iota``, else 1.
    tokens: (M,) int32 -> (M,) float32."""
    return ((global_step - tokens) <= iota).float()
