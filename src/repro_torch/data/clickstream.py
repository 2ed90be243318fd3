"""Synthetic skewed click-log stream (Criteo/Alimama/Private stand-in).

The offline container cannot download Criteo-1TB / Alimama, so we generate a
stream with the properties the paper's analysis relies on:

* **Zipf-skewed ID occurrences** (Fig. 4): most IDs appear in very few
  batches, a few appear everywhere — this is what makes embedding params
  staleness-robust (Insight 2).
* A **learnable ground-truth CTR model**: labels are drawn from a logistic
  model over latent field/ID factors, so AUC is a meaningful accuracy metric
  and training curves behave like real CTR training (converging AUC < 1).
* **Day partitions** for the paper's continual-training protocol (train on
  day d, evaluate on day d+1) with mild day-to-day drift.

Deterministic: every batch is a pure function of (seed, day, batch index),
so async/sync/GBA runs consume identical data regardless of worker order.

A copy of ``repro.data.clickstream`` (numpy only): the same seed gives
arrays identical to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.recsys import RecsysConfig


@dataclass
class ClickStream:
    cfg: RecsysConfig
    seed: int
    zipf_a: float
    num_days: int
    batches_per_day: int
    batch_size: int
    drift: float

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.cfg.hash_capacity
        D = 8  # latent dim of the ground-truth model
        self._id_factors = rng.normal(0, 1, (V, D)).astype(np.float32)
        self._field_w = rng.normal(0, 1, (self.cfg.num_fields, D)).astype(
            np.float32)
        self._beh_w = rng.normal(0, 1, (D,)).astype(np.float32)
        self._day_drift = rng.normal(0, self.drift,
                                     (self.num_days, D)).astype(np.float32)
        # Zipf ranks -> per-field ID pools (fields see disjoint slices)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self._id_probs = (probs / probs.sum()).astype(np.float64)

    def _draw_ids(self, rng, shape) -> np.ndarray:
        return rng.choice(self.cfg.hash_capacity, size=shape,
                          p=self._id_probs).astype(np.int32)

    def batch(self, day: int, index: int, batch_size: int | None = None
              ) -> dict:
        """Pure function of (seed, day, index)."""
        bs = batch_size or self.batch_size
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + day) * 1_000_003 + index)
        cfg = self.cfg
        fields = self._draw_ids(rng, (bs, cfg.num_fields))
        out = {"fields": fields}
        logit = (self._id_factors[fields] * self._field_w[None]).sum(
            axis=(1, 2)) / np.sqrt(cfg.num_fields)
        if cfg.behavior_len:
            behavior = self._draw_ids(rng, (bs, cfg.behavior_len))
            target = self._draw_ids(rng, (bs,))
            out["behavior"] = behavior
            out["target"] = target
            # behavior-target affinity drives the label, like real CTR data
            aff = (self._id_factors[behavior].mean(axis=1)
                   * self._id_factors[target]).sum(axis=-1)
            logit = logit + aff * 2.0
        drift = self._day_drift[day % self.num_days]
        logit = logit + (self._id_factors[fields[:, 0]] * drift).sum(axis=-1)
        logit = logit - 1.0  # CTR base rate < 0.5
        p = 1.0 / (1.0 + np.exp(-logit))
        out["label"] = (rng.uniform(size=bs) < p).astype(np.float32)
        return out

    def day_batches(self, day: int):
        for i in range(self.batches_per_day):
            yield self.batch(day, i)


def make_clickstream(cfg: RecsysConfig, seed: int = 0, zipf_a: float = 1.2,
                     num_days: int = 8, batches_per_day: int = 64,
                     batch_size: int = 256, drift: float = 0.05
                     ) -> ClickStream:
    return ClickStream(cfg, seed, zipf_a, num_days, batches_per_day,
                       batch_size, drift)
