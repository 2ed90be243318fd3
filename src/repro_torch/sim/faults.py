"""Deterministic fault plans for the end-to-end switching harness.

``sim.cluster`` draws crashes from ``failure_rate`` *inside* its own event
loop — fine for schedule statistics, but the switching driver
(``launch.switch_driver``) needs the SAME faults to hit two runs (auto
vs forced-sync) at the same sim-clock times so speedup and recovery
claims compare like with like.  A :class:`FaultPlan` is that fixed
script: per-worker straggler windows (multiplicative slowdowns over a
time interval), transient crashes (Alg. 1 semantics — the in-flight
token is lost, the worker rejoins after its recovery time), telemetry
scrape dropouts (a window during which the controller sees no rates),
and async apply failures (global steps whose PS write is dropped, the
circuit-breaker trigger).

Plans are pure frozen data.  :class:`FaultInjector` is the runtime that
consumes a plan: it draws per-batch jitter from ``ClusterSpec``, tracks
which crash events have fired and until when each worker is down, and
counts what was lost — the driver asks it questions, it never touches
driver state.

``FaultPlan.strained`` builds the acceptance scenario (25% stragglers at
4x + one transient crash); ``FaultPlan.from_cluster_spec`` derives a plan
from an existing :class:`~repro_torch.sim.cluster.ClusterSpec` so sim studies
and driver runs share one vocabulary.

A copy of ``repro.sim.faults`` (numpy only): a plan, a spec and a seed give
the same durations, crash times, scrapes and apply failures in both
packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.sim.cluster import ClusterSpec

INF = float("inf")


@dataclass(frozen=True)
class StragglerWindow:
    """Worker ``worker`` computes ``slowdown``x slower during
    [``start``, ``end``).  Overlapping windows on one worker multiply."""
    worker: int
    slowdown: float = 4.0
    start: float = 0.0
    end: float = INF

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"worker must be >= 0, got {self.worker}")
        if self.slowdown <= 0:
            raise ValueError(f"slowdown must be > 0, got {self.slowdown}")
        if self.end < self.start:
            raise ValueError(f"window ends ({self.end}) before it starts "
                             f"({self.start})")

    def active(self, t: float) -> bool:
        return self.start <= t < self.end


@dataclass(frozen=True)
class CrashEvent:
    """Worker ``worker`` dies at sim time ``at``: the batch it is
    computing (and its token) is lost — Alg. 1 — and it rejoins at
    ``at + recovery``."""
    worker: int
    at: float
    recovery: float = 5.0

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"worker must be >= 0, got {self.worker}")
        if self.recovery < 0:
            raise ValueError(f"recovery must be >= 0, got {self.recovery}")


@dataclass(frozen=True)
class ScrapeDropout:
    """Telemetry scrapes inside [``start``, ``end``) return nothing —
    the controller must hold its mode on the empty window."""
    start: float
    end: float

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"dropout ends ({self.end}) before it starts "
                             f"({self.start})")


@dataclass(frozen=True)
class FaultPlan:
    """A fixed, replayable script of faults for ``num_workers`` workers.

    ``apply_failures`` lists global steps whose async PS apply fails
    (gradients lost, params not committed) — repeated failures trip the
    driver's fallback-to-sync circuit breaker.
    """
    num_workers: int
    stragglers: tuple[StragglerWindow, ...] = ()
    crashes: tuple[CrashEvent, ...] = ()
    dropouts: tuple[ScrapeDropout, ...] = ()
    apply_failures: tuple[int, ...] = ()

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {self.num_workers}")
        for s in self.stragglers:
            if s.worker >= self.num_workers:
                raise ValueError(
                    f"straggler worker {s.worker} out of range "
                    f"[0, {self.num_workers})")
        for c in self.crashes:
            if c.worker >= self.num_workers:
                raise ValueError(
                    f"crash worker {c.worker} out of range "
                    f"[0, {self.num_workers})")
        # crashes sorted by time makes the injector's scan deterministic
        object.__setattr__(self, "crashes",
                           tuple(sorted(self.crashes,
                                        key=lambda c: (c.at, c.worker))))

    # -- queries ------------------------------------------------------------
    def slowdown(self, worker: int, t: float) -> float:
        """Multiplicative slowdown of ``worker`` at sim time ``t``."""
        s = 1.0
        for w in self.stragglers:
            if w.worker == worker and w.active(t):
                s *= w.slowdown
        return s

    def scrape_lost(self, t: float) -> bool:
        return any(d.start <= t < d.end for d in self.dropouts)

    def straggler_workers(self) -> tuple[int, ...]:
        return tuple(sorted({w.worker for w in self.stragglers}))

    # -- constructors -------------------------------------------------------
    @classmethod
    def quiet(cls, num_workers: int) -> "FaultPlan":
        """No faults — the vacant-cluster baseline."""
        return cls(num_workers)

    @classmethod
    def strained(cls, num_workers: int, *, straggler_frac: float = 0.25,
                 slowdown: float = 4.0, crash_at: float | None = None,
                 recovery: float = 5.0, seed: int = 0) -> "FaultPlan":
        """The acceptance scenario: ``straggler_frac`` of the workers run
        ``slowdown``x slower for the whole run, plus ONE transient crash
        of a healthy worker at ``crash_at`` (default: 2 recovery periods
        in, so the run both loses the token and sees the rejoin)."""
        rng = np.random.default_rng(seed)
        n_slow = int(round(straggler_frac * num_workers))
        slow = sorted(rng.choice(num_workers, n_slow, replace=False))
        healthy = [w for w in range(num_workers) if w not in slow]
        victim = int(healthy[0] if healthy else 0)
        at = 2.0 * recovery if crash_at is None else crash_at
        return cls(
            num_workers,
            stragglers=tuple(StragglerWindow(int(w), slowdown)
                             for w in slow),
            crashes=(CrashEvent(victim, at, recovery),))

    @classmethod
    def from_cluster_spec(cls, spec: ClusterSpec, horizon: float,
                          local_batch: int = 256) -> "FaultPlan":
        """Derive a replayable plan from a :class:`ClusterSpec`:
        stragglers from ``straggler_frac``/``straggler_slowdown`` (same
        rng stream as ``worker_speeds``, so the SAME workers straggle),
        crashes sampled over [0, ``horizon``) from ``failure_rate`` (a
        per-batch probability, converted through the healthy batch
        duration) with ``recovery_time`` recoveries."""
        rng = np.random.default_rng(spec.seed)
        speeds = spec.worker_speeds(rng)
        stragglers = tuple(
            StragglerWindow(w, float(spec.base_speed / speeds[w]))
            for w in range(spec.num_workers)
            if speeds[w] < spec.base_speed)
        crashes = []
        if spec.failure_rate:
            batch_dur = local_batch / spec.base_speed
            # per-batch crash probability -> Poisson rate per second
            rate = -math.log(max(1.0 - spec.failure_rate, 1e-12)) / batch_dur
            for w in range(spec.num_workers):
                t = float(rng.exponential(1.0 / rate))
                while t < horizon:
                    crashes.append(CrashEvent(w, t, spec.recovery_time))
                    t += spec.recovery_time + float(
                        rng.exponential(1.0 / rate))
        return cls(spec.num_workers, stragglers=stragglers,
                   crashes=tuple(crashes))


class FaultInjector:
    """Runtime over one (:class:`FaultPlan`, :class:`ClusterSpec`) pair.

    Owns the jitter rng and all fault bookkeeping: which crash events
    have fired, until when each worker is down, and the loss counters.
    The driver asks (``duration``, ``crash_between``, ``is_down``,
    ``scrape``, ``apply_fails``); the injector never reaches into driver
    state, so two drivers replaying the same plan/spec/seed see
    identical faults.
    """

    def __init__(self, plan: FaultPlan, spec: ClusterSpec, seed: int = 0):
        if spec.num_workers != plan.num_workers:
            raise ValueError(
                f"spec has {spec.num_workers} workers, plan has "
                f"{plan.num_workers}")
        self.plan = plan
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self._base = np.full(spec.num_workers, spec.base_speed)
        self.down_until = np.zeros(spec.num_workers)
        self._fired: set[int] = set()       # indices into plan.crashes
        self.crash_log: list[CrashEvent] = []
        self.lost_tokens = 0
        self.dropped_scrapes = 0

    # -- timing -------------------------------------------------------------
    def duration(self, worker: int, t: float, local_batch: int) -> float:
        """Compute time of one local batch on ``worker`` starting at
        ``t``: spec jitter/contention on the healthy base speed, times
        the plan's straggler slowdown."""
        s = self.spec.speed_at(self._base, worker, t, self.rng)
        s = s / self.plan.slowdown(worker, t)
        return local_batch / max(s, 1e-3)

    # -- crashes ------------------------------------------------------------
    def crash_between(self, worker: int, t0: float,
                      t1: float) -> CrashEvent | None:
        """First unfired crash of ``worker`` in (``t0``, ``t1``]; firing
        it marks the worker down until ``at + recovery`` and counts the
        lost token (Alg. 1: the in-flight gradient disappears)."""
        for i, ev in enumerate(self.plan.crashes):
            if i in self._fired or ev.worker != worker:
                continue
            if t0 < ev.at <= t1:
                self._fired.add(i)
                self.down_until[worker] = max(self.down_until[worker],
                                              ev.at + ev.recovery)
                self.crash_log.append(ev)
                self.lost_tokens += 1
                return ev
        return None

    def is_down(self, worker: int, t: float) -> bool:
        return t < self.down_until[worker]

    # -- telemetry / PS -----------------------------------------------------
    def scrape(self, t: float, rates):
        """Rates as the controller sees them: ``None`` (counted) when the
        scrape falls in a dropout window."""
        if self.plan.scrape_lost(t):
            self.dropped_scrapes += 1
            return None
        return rates

    def apply_fails(self, gstep: int) -> bool:
        return gstep in self.plan.apply_failures
