"""Public serving API of the port: the recsys scoring engine over the
parameter-source abstraction.

* :class:`RecsysScoringEngine` — batched ID-list scoring with the hot-ID
  embedding cache (``serving.recsys``);
* :class:`StaticSource` / :class:`LiveSource` + :class:`UpdateChannel` —
  frozen-checkpoint vs streaming-from-the-trainer params
  (``serving.sources``);
* :class:`ServingConfig` — the knob dataclass.

The LM engine of ``repro.serving`` is not ported yet.
"""
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.recsys import RecsysScoringEngine, init_scoring_params
from repro_torch.serving.sources import (LiveSource, ParamSource, Snapshot,
                                         StaticSource, UpdateChannel)

__all__ = [
    "LiveSource",
    "ParamSource",
    "RecsysScoringEngine",
    "ServingConfig",
    "Snapshot",
    "StaticSource",
    "UpdateChannel",
    "init_scoring_params",
]
