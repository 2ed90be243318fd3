"""GBA's training core in the port: the schedule-replay trainer and the
continual-training loop (exported here), the flat buffer of the fused LM
step (``core.gba``), and the worker-parallel wire step with its sharded
layout, compression policy and Eq. (1) decay (``core.gba_shard_map``,
``core.flat_sharded``, ``core.compression``, ``core.staleness``).  The
token module and the pytree aggregation of ``repro.core`` wait
(ROADMAP.md)."""
from repro_torch.core.continual import (ContinualResult, ModeSetup,
                                        default_setups, pretrain_sync,
                                        run_continual, schedule_for_day)
from repro_torch.core.trainer import (EMBED_KEYS, GBATrainer, ReplayStats,
                                      VersionRing, evaluate)

__all__ = ["ContinualResult", "EMBED_KEYS", "GBATrainer", "ModeSetup",
           "ReplayStats", "VersionRing", "default_setups", "evaluate",
           "pretrain_sync", "run_continual", "schedule_for_day"]
