"""GBA's training loop in the port: the schedule-replay trainer and the
continual-training loop.  The token, staleness and flat-buffer modules
of ``repro.core`` wait for the slice that ports ``gba_apply``."""
from repro_torch.core.continual import (ContinualResult, ModeSetup,
                                        default_setups, pretrain_sync,
                                        run_continual, schedule_for_day)
from repro_torch.core.trainer import (EMBED_KEYS, GBATrainer, ReplayStats,
                                      VersionRing, evaluate)

__all__ = ["ContinualResult", "EMBED_KEYS", "GBATrainer", "ModeSetup",
           "ReplayStats", "VersionRing", "default_setups", "evaluate",
           "pretrain_sync", "run_continual", "schedule_for_day"]
