"""Public serving API of the port: the recsys scoring engine and the LM's
continuous-batching engine over the parameter-source abstraction.

* :class:`RecsysScoringEngine` — batched ID-list scoring with the hot-ID
  embedding cache (``serving.recsys``);
* :class:`ServingEngine` + :class:`Request` — greedy LM decoding with
  slot-based continuous batching (``serving.engine``);
* :class:`StaticSource` / :class:`LiveSource` + :class:`UpdateChannel` —
  frozen-checkpoint vs streaming-from-the-trainer params
  (``serving.sources``);
* :class:`ServingConfig` — the knob dataclass.
"""
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.recsys import RecsysScoringEngine, init_scoring_params
from repro_torch.serving.sources import (LiveSource, ParamSource, Snapshot,
                                         StaticSource, UpdateChannel)

__all__ = [
    "LiveSource",
    "ParamSource",
    "RecsysScoringEngine",
    "Request",
    "ServingConfig",
    "ServingEngine",
    "Snapshot",
    "StaticSource",
    "UpdateChannel",
    "init_scoring_params",
]
