"""Staleness decay over the token index (paper Eq. (1)).

Counterpart of ``repro.core.staleness``.  The paper's strategy is the hard
threshold; the reference also has two smooth variants (exponential and
linear) as beyond-paper extension hooks, selected by name through
``DECAY_FNS`` (``core.gba.decay_weights``).  Each takes the (M,) int32
slot tokens and the global step and returns (M,) float32 weights.
"""
from __future__ import annotations

import torch


def threshold_decay(tokens: torch.Tensor, global_step: int,
                    iota: int) -> torch.Tensor:
    """Eq. (1): weight 0 where ``global_step - token > iota``, else 1.
    tokens: (M,) int32 -> (M,) float32."""
    return ((global_step - tokens) <= iota).float()


def exponential_decay(tokens: torch.Tensor, global_step: int, iota: int,
                      alpha: float = 0.5) -> torch.Tensor:
    """Beyond-paper: ``alpha ** max(stale, 0)``, hard zero past iota."""
    stale = torch.clamp(global_step - tokens, min=0).float()
    w = torch.pow(torch.tensor(alpha, dtype=torch.float32), stale)
    return torch.where(global_step - tokens > iota, 0.0, w)


def linear_decay(tokens: torch.Tensor, global_step: int,
                 iota: int) -> torch.Tensor:
    """Beyond-paper: ``1 - stale / (iota + 1)``, clipped to [0, 1]."""
    stale = torch.clamp(global_step - tokens, min=0).float()
    return torch.clamp(1.0 - stale / (iota + 1.0), 0.0, 1.0)


DECAY_FNS = {
    "threshold": threshold_decay,
    "exponential": exponential_decay,
    "linear": linear_decay,
}
