"""LRU hot-ID cache in front of the device-resident embedding table.

Counterpart of ``repro.embeddings.hot_cache``, with the same contracts:

* A batch whose unique ids all hit is served from host memory without
  invoking the lookup kernel (``repro_torch.kernels.ops.kernel_calls``
  stays put).
* Every cached row is stamped with the snapshot version it was fetched
  under.  :meth:`HotIDCache.bump_version` drops the rows an update touched
  (all rows for ``touched_ids=None``) and keeps the rest, whose table rows
  are bit-identical in the new snapshot.  A ``put_many`` carrying another
  version than the cache's is ignored: a sync landed between the miss fetch
  and its insertion.
* :func:`cached_pooled_lookup` pools in float32 numpy on the host over
  per-unique-ID rows.  Misses are fetched through the kernel as pools of
  one id, which return the rows exactly, so any hit/miss mix gives
  bit-identical pooled vectors.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.embeddings.table import EmbeddingTable
from repro_torch.kernels import ops


def _pad_pow2(n: int, floor: int = 8) -> int:
    """Pad miss-batch sizes to a power of two (>= floor), so the kernel sees
    a bounded set of shapes, as in the JAX package."""
    p = floor
    while p < n:
        p *= 2
    return p


class HotIDCache:
    """Thread-safe LRU of (hashed id -> f32 row) with version stamping.

    ``capacity`` is the max resident rows; ``dim`` the row width.  Reads
    and writes take a short lock around dict ops only, never around a
    kernel call."""

    def __init__(self, capacity: int, dim: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.version = 1
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._lock = threading.Lock()
        self._rows: OrderedDict[int, np.ndarray] = OrderedDict()

    @property
    def nbytes(self) -> int:
        """Worst-case resident bytes: capacity f32 rows."""
        return self.capacity * self.dim * 4

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def hit_rate(self) -> float:
        with self._lock:   # hits/misses move together under the lock
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def get_many(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """ids: (n,) unique int -> (rows (n, dim) f32, found (n,) bool).
        Rows for missing ids are zero-filled (caller overwrites them)."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.zeros((ids.shape[0], self.dim), np.float32)
        found = np.zeros(ids.shape[0], bool)
        with self._lock:
            for i, raw in enumerate(ids):
                key = int(raw)
                row = self._rows.get(key)
                if row is not None:
                    self._rows.move_to_end(key)   # LRU touch
                    rows[i] = row
                    found[i] = True
            self.hits += int(found.sum())
            self.misses += int((~found).sum())
        return rows, found

    def put_many(self, ids: np.ndarray, rows: np.ndarray,
                 version: int) -> bool:
        """Insert freshly fetched rows.  Dropped (returns False) when
        ``version`` is not the cache's current version: the miss fetch
        raced a sync and its rows may be stale."""
        with self._lock:
            if int(version) != self.version:
                return False
            for raw, row in zip(np.asarray(ids).reshape(-1), rows):
                self._rows[int(raw)] = np.asarray(row, np.float32)
                self._rows.move_to_end(int(raw))
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
                self.evictions += 1
            return True

    def bump_version(self, version: int,
                     touched_ids: np.ndarray | None = None) -> None:
        """Adopt a new snapshot version.  Entries for ``touched_ids`` are
        dropped; the rest stay valid (their rows did not change).  With
        ``touched_ids=None`` the whole cache is cleared."""
        with self._lock:
            if touched_ids is None:
                self.invalidations += len(self._rows)
                self._rows.clear()
            else:
                for raw in np.asarray(touched_ids).reshape(-1):
                    if self._rows.pop(int(raw), None) is not None:
                        self.invalidations += 1
            self.version = int(version)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()


def fetch_rows(table: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """Exact table rows through the lookup kernel, as f32 numpy.

    The ids are shaped (n_pad, 1), so each output is a pool of one id: the
    row itself.  The batch is padded to a power of two with the
    out-of-range sentinel id ``capacity``, which the kernel maps to a zero
    row; the padding rows are sliced off on the host."""
    ids = np.asarray(ids).reshape(-1)
    n = ids.shape[0]
    padded = np.full((_pad_pow2(n), 1), table.shape[0], np.int32)  # sentinel
    padded[:n, 0] = ids
    rows = ops.pooled_lookup(torch.from_numpy(padded).to(table.device), table)
    return rows.to(torch.float32).cpu().numpy()[:n]


def cached_pooled_lookup(cache: HotIDCache | None, tbl: EmbeddingTable,
                         hashed_ids: np.ndarray, *,
                         version: int = 1) -> np.ndarray:
    """Sum-pooled lookup (B, F) -> (B, dim) through the hot-ID cache.

    Unique hit ids are served from the cache; misses go through
    :func:`fetch_rows` (the kernel) and are inserted under ``version``.  A
    batch with no unique miss launches no kernel.  The output is f32 numpy,
    bit-identical whatever the hit/miss mix (module docstring)."""
    ids = np.asarray(hashed_ids)
    B, F = ids.shape
    uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
    if cache is None:
        rows = fetch_rows(tbl.table, uniq)
    else:
        rows, found = cache.get_many(uniq)
        miss = ~found
        if miss.any():
            fetched = fetch_rows(tbl.table, uniq[miss])
            rows[miss] = fetched
            cache.put_many(uniq[miss], fetched, version)
    return rows[inv].reshape(B, F, rows.shape[-1]).sum(axis=1,
                                                       dtype=np.float32)
