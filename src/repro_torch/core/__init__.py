"""GBA's training core in the port: the token list (``core.tokens``), the
pytree aggregation and buffer and the flat buffer of the fused LM step
(``core.gba``), the Eq. (1) decay strategies (``core.staleness``), the
schedule-replay trainer and the continual-training loop, and the
worker-parallel wire step with its sharded layout and compression policy
(``core.gba_shard_map``, ``core.flat_sharded``, ``core.compression``)."""
from repro_torch.core.continual import (ContinualResult, ModeSetup,
                                        default_setups, pretrain_sync,
                                        run_continual, schedule_for_day)
from repro_torch.core.gba import (FlatLayout, aggregate_dense,
                                  aggregate_embedding,
                                  buffer_push_and_maybe_apply, decay_weights,
                                  flat_buffer_push,
                                  flat_buffer_push_and_maybe_apply,
                                  init_buffer, init_flat_buffer)
from repro_torch.core.staleness import (DECAY_FNS, exponential_decay,
                                        linear_decay, threshold_decay)
from repro_torch.core.tokens import (TokenList, TokenListExhausted,
                                     num_global_steps, token_for_batch,
                                     token_list)
from repro_torch.core.trainer import (EMBED_KEYS, GBATrainer, ReplayStats,
                                      VersionRing, evaluate)

__all__ = ["ContinualResult", "DECAY_FNS", "EMBED_KEYS", "FlatLayout",
           "GBATrainer", "ModeSetup", "ReplayStats", "TokenList",
           "TokenListExhausted", "VersionRing", "aggregate_dense",
           "aggregate_embedding", "buffer_push_and_maybe_apply",
           "decay_weights", "default_setups", "evaluate",
           "exponential_decay", "flat_buffer_push",
           "flat_buffer_push_and_maybe_apply", "init_buffer",
           "init_flat_buffer", "linear_decay", "num_global_steps",
           "pretrain_sync", "run_continual", "schedule_for_day",
           "threshold_decay", "token_for_batch", "token_list"]
