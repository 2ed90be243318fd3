"""Parameter sources: where a serving engine's weights come from.

Counterpart of ``repro.serving.sources``, with the same contracts:

* :class:`Snapshot` is an immutable ``(version, step, params)`` triple.
  Engines pin one snapshot per score call, so a sync landing mid-call never
  mixes two parameter versions inside one output.
* :class:`StaticSource` is the frozen-checkpoint case (version stays 1);
  ``StaticSource.from_checkpoint`` restores the params tree from an npz
  file in the JAX package's layout, onto a device.
* :class:`UpdateChannel` + :class:`LiveSource` are the online path.  The
  trainer publishes states into the channel (newest wins; touched-ID sets
  are unioned, so a consumer that skips states still invalidates every row
  any skipped state touched).  A LiveSource daemon thread takes them at
  ``sync_interval`` and swaps in a fresh Snapshot; ``snapshot()`` is a plain
  attribute read and never blocks; ``close(grace)`` stops the thread.

Snapshots are never mutated: a sync swaps the reference.  So a published
state must be tensors the trainer will not update in place afterwards.
Listeners are notified after the swap with ``(snapshot, touched_ids)``;
``touched_ids=None`` means "assume everything changed".
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import tree_to_device
from repro_torch.kernels.runtime import resolve_device

_log = logging.getLogger(__name__)


class Snapshot(NamedTuple):
    """One immutable parameter state.  ``version`` is the source-local sync
    counter (+1 per applied sync); ``step`` is the trainer's global step
    this state came from (freshness lag = trainer step now - step)."""
    version: int
    step: int
    params: Any


class ParamSource:
    """Protocol: ``snapshot() -> Snapshot``, listener registration and
    ``close()``.  The base class holds the listener plumbing and a no-op
    close."""

    def snapshot(self) -> Snapshot:
        raise NotImplementedError

    def add_listener(self, fn: Callable[[Snapshot, Any], None]) -> None:
        """``fn(snapshot, touched_ids)`` is called after every version swap.
        ``touched_ids`` is a 1-D int array of embedding rows the update
        touched, or None for "invalidate everything"."""
        self._listeners = getattr(self, "_listeners", [])
        self._listeners.append(fn)

    def _notify(self, snap: Snapshot, touched: Any) -> None:
        for fn in getattr(self, "_listeners", []):
            fn(snap, touched)

    def close(self, grace: float = 1.0) -> None:  # noqa: ARG002
        return None


class StaticSource(ParamSource):
    """Frozen params: one Snapshot, version 1, forever."""

    def __init__(self, params: Any, step: int = 0):
        self._snap = Snapshot(version=1, step=int(step), params=params)

    @classmethod
    def from_checkpoint(cls, path: str, step: int = 0,
                        select: str | None = None, *,
                        device: str | torch.device = "cuda"
                        ) -> "StaticSource":
        """Restore from an npz checkpoint file, or from a checkpoint
        directory (the newest ``ckpt_<step>.npz`` wins and stamps the
        snapshot's ``step``), onto ``device``.  ``select`` picks one
        subtree of the stored state, e.g. ``"params"`` when the checkpoint
        holds a full train state."""
        dev = resolve_device(device)
        if os.path.isdir(path):
            step, path = CheckpointManager(path).latest_path()
        tree = load_pytree(path)
        if select is not None:
            tree = tree[select]
        return cls(tree_to_device(tree, dev), step=step)

    def snapshot(self) -> Snapshot:
        return self._snap


class UpdateChannel:
    """The trainer-side mailbox of the live sync channel.

    ``publish`` holds a short lock only: it replaces the pending state
    (coalescing, the async-model-average semantics) and unions the
    touched-ID sets."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: tuple[Any, int] | None = None   # (params, step)
        self._touched: np.ndarray | None = None
        self._touched_valid = True   # False once any publish omitted ids
        self.published = 0
        self.coalesced = 0
        self.last_step = -1

    def publish(self, params: Any, step: int,
                touched_ids: Any | None = None) -> None:
        """Offer a new parameter state.  ``touched_ids``: embedding rows
        this state changed relative to the previously published one."""
        with self._lock:
            if self._pending is not None:
                self.coalesced += 1
            self._pending = (params, int(step))
            self.last_step = int(step)
            if touched_ids is None:
                self._touched_valid = False
                self._touched = None
            elif self._touched_valid:
                t = np.asarray(touched_ids).reshape(-1)
                self._touched = (t if self._touched is None
                                 else np.union1d(self._touched, t))
            self.published += 1

    def newest_step(self) -> int:
        """Newest published trainer step (-1 before any publish), read
        under the channel lock."""
        with self._lock:
            return self.last_step

    def take(self) -> tuple[Any, int, np.ndarray | None] | None:
        """Consumer side: pop the newest pending state (or None)."""
        with self._lock:
            if self._pending is None:
                return None
            params, step = self._pending
            touched = self._touched if self._touched_valid else None
            self._pending = None
            self._touched = None
            self._touched_valid = True
            return params, step, touched


class LiveSource(ParamSource):
    """Streaming params from an :class:`UpdateChannel`, applied by a daemon
    sync thread every ``sync_interval`` seconds.

    * ``snapshot()`` is the hot path: one attribute read, no lock.
    * ``sync_now()`` applies any pending state synchronously
      (``start=False`` gives a purely pull-based source).
    * ``close(grace)`` sets the stop event and joins the thread up to
      ``grace`` seconds.  A closed source keeps serving its last snapshot.
    """

    def __init__(self, channel: UpdateChannel, init_params: Any, *,
                 sync_interval: float = 0.05, start: bool = True):
        self.channel = channel
        self.sync_interval = float(sync_interval)
        self._snap = Snapshot(version=1, step=0, params=init_params)
        self._swap_lock = threading.Lock()   # serializes appliers only
        self._stop = threading.Event()
        self.syncs = 0
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="live-param-sync", daemon=True)
            self._thread.start()

    def snapshot(self) -> Snapshot:
        return self._snap          # atomic reference read; never blocks

    def _apply(self, params: Any, step: int, touched) -> Snapshot:
        with self._swap_lock:
            old = self._snap
            snap = Snapshot(version=old.version + 1, step=int(step),
                            params=params)
            self._snap = snap      # the atomic swap
            self.syncs += 1
        self._notify(snap, touched)
        return snap

    def sync_now(self) -> Snapshot | None:
        """Apply the newest pending update, if any.  Returns the new
        snapshot, or None when nothing was pending."""
        item = self.channel.take()
        if item is None:
            return None
        return self._apply(*item)

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_interval):
            try:
                self.sync_now()
            except Exception:      # never kill serving over one bad sync
                _log.exception("live param sync failed; keeping snapshot "
                               "version %d", self._snap.version)

    def close(self, grace: float = 1.0) -> None:
        """Signal the sync thread and join it up to ``grace`` seconds.
        Idempotent."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=grace)
            if self._thread.is_alive():
                raise RuntimeError(
                    "live-param-sync thread did not stop within grace")
            self._thread = None

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def freshness_lag_steps(self) -> int:
        """Trainer steps the current snapshot is behind the newest
        published state (0 when caught up or nothing published).

        The snapshot is read first, then the newest published step under
        the channel lock: a sync between the two reads can only make the
        snapshot newer (clamped to 0), while the other order could report
        a lag for a state the snapshot already holds."""
        snap = self._snap
        last = self.channel.newest_step()
        return max(0, last - snap.step) if last >= 0 else 0
