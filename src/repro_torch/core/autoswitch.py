"""Beyond-paper: adaptive sync/GBA switching (the paper's §6 future work).

The paper: "Currently, GBA requires the users to select the training mode
according to their own judgment on the cluster status.  In the future, we
will attempt to make GBA be adaptive to the cluster status."

GBA makes switching *free*; this controller decides *when*.  It uses only
PS-observable telemetry — per-worker completed-batch counts over the last
window — and estimates what each mode's throughput would be on the current
cluster:

  sync QPS  ~= N * B * min_w(rate_w)     (barrier: slowest worker paces all)
  GBA QPS   ~= B * sum_w(rate_w)         (no waiting)

It switches to GBA when the estimated speedup exceeds ``switch_up`` (with
hysteresis ``switch_down`` for the way back, to avoid flapping).  Because
GBA holds the global batch, switching costs no accuracy (C2) — so the
controller optimizes pure throughput.

A copy of ``repro.core.autoswitch`` (numpy only): the same rates give the
same decisions and summaries in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AutoSwitchController:
    switch_up: float = 1.5      # est. GBA/sync speedup to leave sync
    switch_down: float = 1.15   # est. speedup below which to return
    mode: str = "sync"
    max_history: int = 4096     # decisions kept; long runs stay bounded
    min_dwell: int = 0          # decisions to hold a mode after any switch
    history: list = field(default_factory=list)
    # optional per-mode wire cost, mode -> estimated bytes each worker
    # puts on the wire per global step (e.g. from
    # CompressionPolicy.wire_bytes / layout.padded_total * 4).  Telemetry
    # plumbing ONLY — the switching policy never reads it.
    wire_bytes_per_step: dict | None = None
    dead_workers: int = 0       # zero-rate workers in the last window
    # decisions since the last mode change (switch or force); starts past
    # any dwell so a fresh controller can move on its first decision
    _since_switch: int = field(default=1 << 30, repr=False)

    def estimate_speedup(self, worker_rates) -> float:
        """worker_rates: per-worker samples/s measured over the window
        (``SimMetrics.worker_rates``; on a real PS: completions / wall).

        An EMPTY window — every worker stalled, or the telemetry scrape
        raced the first completion — carries no signal: returns NaN
        rather than crashing on ``min()`` of nothing, and ``decide``
        keeps the current mode (NaN compares False against both
        thresholds).

        A rate of EXACTLY zero is a dead worker (crashed / stalled all
        window), not an infinitely slow one: it is excluded from the
        sync ``min()`` — a barrier would drop it rather than wait
        forever — and counted in :attr:`dead_workers` (``summary()``
        reports it).  All-dead degenerates to the empty window: NaN,
        mode held.  Previously a single zero rate returned ``inf``,
        which instantly forced mode="gba" and pinned it there."""
        rates = np.asarray(worker_rates, dtype=np.float64)
        if rates.size == 0:
            return float("nan")
        alive = rates[rates > 0]
        self.dead_workers = int(rates.size - alive.size)
        if alive.size == 0:
            return float("nan")
        sync_qps = len(alive) * alive.min()
        gba_qps = alive.sum()
        return float(gba_qps / sync_qps)

    def decide(self, worker_rates) -> str:
        """One telemetry decision.  A mode change is only allowed once
        ``min_dwell`` decisions have passed since the previous change
        (or :meth:`force`), so one noisy window cannot flap modes —
        each flap costs a drain + state carryover on the driver."""
        s = self.estimate_speedup(worker_rates)
        prev = self.mode
        if self._since_switch >= self.min_dwell:
            if self.mode == "sync" and s >= self.switch_up:
                self.mode = "gba"
            elif self.mode == "gba" and s <= self.switch_down:
                self.mode = "sync"
        self._since_switch = 0 if self.mode != prev \
            else self._since_switch + 1
        self.history.append((s, self.mode))
        if len(self.history) > self.max_history:
            del self.history[:len(self.history) - self.max_history]
        return self.mode

    def force(self, mode: str) -> str:
        """External override (the driver's fallback-to-sync circuit
        breaker): set the mode and restart the dwell window, so the next
        ``min_dwell`` decisions cannot immediately flip back."""
        if mode not in ("sync", "gba"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self._since_switch = 0
        return self.mode

    def summary(self) -> dict:
        """Telemetry snapshot: current mode, last estimated speedup
        (NaN before any decision — including one made on an empty
        window), decision count, zero-rate (dead) worker count of the
        last non-empty window, and — when ``wire_bytes_per_step`` was
        provided — the current mode's estimated ``bytes_on_wire`` per
        worker per global step plus the full per-mode map.  Read-only:
        never mutates controller state or the switching policy."""
        out = {
            "mode": self.mode,
            "last_speedup": (self.history[-1][0] if self.history
                             else float("nan")),
            "decisions": len(self.history),
            "dead_workers": self.dead_workers,
        }
        if self.wire_bytes_per_step is not None:
            out["bytes_on_wire"] = self.wire_bytes_per_step.get(self.mode)
            out["wire_bytes_per_step"] = dict(self.wire_bytes_per_step)
        return out
