"""Configs for the paper's own recommendation models (Tab. 5.1).

These are the models the GBA paper actually trains: DeepFM on Criteo, DIEN
on Alimama, YouTubeDNN on the Private dataset, on synthetic skewed click
streams (``repro_torch.data``).

A copy of ``repro.configs.recsys``, value for value, so that a config
names the same model in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                          # deepfm | youtubednn | dien
    num_fields: int                     # categorical feature fields
    hash_capacity: int                  # rows in the hashed embedding table
    embed_dim: int
    mlp_dims: Sequence[int]
    behavior_len: int = 0               # DIEN / YouTubeDNN behavior sequence
    source: str = ""


# Laptop-scale versions of the paper's three tasks.  Field counts follow the
# datasets (Criteo: 26 categorical fields; Alimama/Private: user-behavior
# sequence models); capacities are scaled down from the paper's 45B/160B/1.9T
# parameters to fit a CPU container while keeping the Zipf ID skew of Fig. 4.
CRITEO_DEEPFM = RecsysConfig(
    name="criteo-deepfm",
    model="deepfm",
    num_fields=26,
    hash_capacity=100_003,
    embed_dim=16,
    mlp_dims=(256, 128, 64),
    source="GBA paper Tab. 5.1 (Criteo-1TB / DeepFM), scaled",
)

ALIMAMA_DIEN = RecsysConfig(
    name="alimama-dien",
    model="dien",
    num_fields=8,
    hash_capacity=50_021,
    embed_dim=19,
    mlp_dims=(128, 64),
    behavior_len=16,
    source="GBA paper Tab. 5.1 (Alimama / DIEN), scaled",
)

PRIVATE_YOUTUBEDNN = RecsysConfig(
    name="private-youtubednn",
    model="youtubednn",
    num_fields=12,
    hash_capacity=100_003,
    embed_dim=24,
    mlp_dims=(256, 128, 64),
    behavior_len=32,
    source="GBA paper Tab. 5.1 (Private / YouTubeDNN), scaled",
)

RECSYS_CONFIGS = {
    c.name: c for c in (CRITEO_DEEPFM, ALIMAMA_DIEN, PRIVATE_YOUTUBEDNN)
}
