"""Recsys scoring path: batched ID-list requests -> cached lookup through
the ``embedding_bag`` kernel -> dense tower.

Counterpart of ``repro.serving.recsys``.  A request carries ``(B, F)`` raw
categorical ids; the engine hashes them into the embedding table on the
device, sum-pools the rows through the :class:`HotIDCache` (hits from host
memory, misses through the CUDA kernel as pools of one id), and scores the
pooled vector with the dense tower on the device.  The cache and the
pooling stay on the host, in float32 numpy, as in the JAX engine: that is
what makes any hit/miss mix, a live-synced engine and a freshly built one
give bit-identical scores.

Per request the host and the device exchange the miss ids (``(n_pad, 1)``
int32), the fetched rows, the pooled ``(B, D)`` vector and the ``(B,)``
scores; the row and score copies synchronise.

The tower runs ``x @ w + b`` in full float32: resolving a CUDA device
sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
default), so TF32 never rounds the scores.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.convert import tree_to_device
from repro_torch.embeddings.hot_cache import HotIDCache, cached_pooled_lookup
from repro_torch.embeddings.table import EmbeddingTable, hash_ids, init_table
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.recsys import _mlp_fwd, _mlp_init
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sources import ParamSource, Snapshot, StaticSource


def init_scoring_params(capacity: int, dim: int,
                        mlp_dims: tuple[int, ...] = (64, 32), *,
                        generator: torch.Generator,
                        device: str | torch.device = "cuda") -> dict:
    """Fresh serving params on ``device``: a (capacity, dim) embedding
    table and a (dim, *mlp_dims, 1) dense tower, drawn from ``generator``."""
    dev = resolve_device(device)
    return {
        "table": init_table(capacity, dim, generator=generator, device=dev),
        "mlp": _mlp_init((dim, *mlp_dims, 1), generator=generator,
                         device=dev),
    }


def _as_table(t: Any) -> EmbeddingTable:
    """Checkpoint round trips turn the EmbeddingTable NamedTuple into a plain
    tuple; normalise it back."""
    if isinstance(t, EmbeddingTable):
        return t
    if isinstance(t, (tuple, list)):
        return EmbeddingTable(t[0], t[1])
    raise TypeError(f"expected EmbeddingTable, got {type(t)!r}")


class RecsysScoringEngine:
    """Batched ID-list scoring with a hot-ID cache and live param sync.

    ``source`` snapshots carry ``{"table": EmbeddingTable, "mlp": params}``
    (see :func:`init_scoring_params`); a raw params dict is wrapped in a
    StaticSource.  Params on another device are copied to ``device``.
    ``config.cache_capacity`` sizes the hot-ID cache (0 = no cache, every
    lookup goes to the kernel)."""

    def __init__(self, source: ParamSource | dict, *,
                 config: ServingConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if not isinstance(source, ParamSource):
            source = StaticSource(source)
        self.source = source
        self.config = config or ServingConfig()
        snap = source.snapshot()
        self._table, self._mlp = self._place(snap.params)
        self._version = snap.version
        self.param_step = snap.step
        self._n_mlp = sum(1 for k in self._mlp if k.startswith("w"))
        dim = self._table.table.shape[1]
        self.cache = (HotIDCache(self.config.cache_capacity, dim)
                      if self.config.cache_capacity else None)
        if self.cache is not None:
            self.cache.bump_version(snap.version)
        self._sync_lock = threading.Lock()
        self.requests = 0
        self.scored = 0
        self.syncs_adopted = 0
        self.latencies_us: list[float] = []
        # (hash, lookup, tower) host-clock µs of each score call
        self.stages_us: list[tuple[float, float, float]] = []
        source.add_listener(self._on_sync)

    def _place(self, params: dict) -> tuple[EmbeddingTable, dict]:
        placed = tree_to_device(
            {"table": _as_table(params["table"]), "mlp": params["mlp"]},
            self.device)
        return placed["table"], placed["mlp"]

    # -- live sync ---------------------------------------------------------
    def _on_sync(self, snap: Snapshot, touched: Any) -> None:
        """Runs on the sync thread after each version swap: adopt the new
        table and tower and drop exactly the cache rows the update touched.
        The lock makes the (table, mlp, version) triple and the cache's
        invalidation visible together; scoring holds it for a reference
        copy, never across a kernel call.

        The cache is bumped under the lock, unlike the JAX engine: a score
        pinning the new table before the touched rows left the cache would
        pool stale cached rows with fresh fetched ones."""
        table, mlp = self._place(snap.params)
        with self._sync_lock:
            self._table = table
            self._mlp = mlp
            self._version = snap.version
            self.param_step = snap.step
            self.syncs_adopted += 1
            if self.cache is not None:
                self.cache.bump_version(snap.version, touched)

    def _pin(self) -> tuple[EmbeddingTable, Any, int]:
        with self._sync_lock:
            return self._table, self._mlp, self._version

    # -- scoring hot path --------------------------------------------------
    def score(self, raw_ids: np.ndarray) -> np.ndarray:
        """(B, F) raw categorical ids -> (B,) f32 scores, all under one
        pinned parameter version."""
        t0 = time.perf_counter()
        table, mlp, version = self._pin()
        hashed = hash_ids(torch.from_numpy(np.asarray(raw_ids)),
                          table.table.shape[0]).numpy()
        t1 = time.perf_counter()
        pooled = cached_pooled_lookup(self.cache, table, hashed,
                                      version=version)
        t2 = time.perf_counter()
        x = torch.from_numpy(pooled).to(self.device)
        out = torch.sigmoid(_mlp_fwd(mlp, x, self._n_mlp)[:, 0]).cpu().numpy()
        t3 = time.perf_counter()
        self.requests += 1
        self.scored += out.shape[0]
        self.latencies_us.append((t3 - t0) * 1e6)
        self.stages_us.append(((t1 - t0) * 1e6, (t2 - t1) * 1e6,
                               (t3 - t2) * 1e6))
        return out

    def close(self, grace: float = 1.0) -> None:
        self.source.close(grace)

    def stats(self) -> dict:
        lat = np.asarray(self.latencies_us, np.float64)
        with self._sync_lock:
            # one consistent view: a sync between these reads could
            # otherwise pair the new version with the old step
            version, step, adopted = (self._version, self.param_step,
                                      self.syncs_adopted)
        out = {
            "requests": self.requests,
            "scored": self.scored,
            "param_version": version,
            "param_step": step,
            "syncs_adopted": adopted,
            "hit_rate": self.cache.hit_rate if self.cache else 0.0,
            "cache_rows": len(self.cache) if self.cache else 0,
            "cache_bytes": self.cache.nbytes if self.cache else 0,
        }
        if lat.size:
            out["p50_us"] = float(np.percentile(lat, 50))
            out["p99_us"] = float(np.percentile(lat, 99))
        return out
