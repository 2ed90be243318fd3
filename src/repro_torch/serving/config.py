"""Serving configuration: the knobs of the ``repro_torch.serving`` API.

Counterpart of ``repro.serving.config``, field for field and with the same
validation, so one config reads the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServingConfig:
    """Knobs shared by the serving engines.

    ``num_slots`` / ``max_len`` shape the LM engine's decode batch
    (``serving.engine``); ``sync_interval`` is the LiveSource sync thread's period in
    seconds; ``cache_capacity`` sizes the hot-ID embedding cache in resident
    rows (0 disables it: every lookup goes to the kernel)."""
    num_slots: int = 4
    max_len: int = 256
    sync_interval: float = 0.05
    cache_capacity: int = 4096

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.sync_interval <= 0:
            raise ValueError(f"sync_interval must be > 0, "
                             f"got {self.sync_interval}")
        if self.cache_capacity < 0:
            raise ValueError(f"cache_capacity must be >= 0, "
                             f"got {self.cache_capacity}")
