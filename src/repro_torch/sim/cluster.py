"""Event-driven shared-cluster simulator.

Models the paper's Section 3.2 environment: N workers with heterogeneous,
time-varying speeds pull (params, batch, token) from the PS, compute, and
push gradients.  Six training modes are simulated:

  sync    AR barrier: step time = slowest worker (+ all-reduce latency)
  async   every gradient applied immediately (global step per gradient)
  bsp     aggregate ``b2`` gradients per apply, regardless of version
  hop_bs  bounded staleness: a worker blocks when it is more than ``b1``
          completed-batches ahead of the slowest worker
  hop_bw  backup workers: per synchronized round, the ``b3`` slowest
          gradients are dropped
  gba     token-control: async pulls; buffer of M; Eq.(1) decay with
          tolerance iota drops severely-stale gradients

Outputs a :class:`Schedule` — for every global step, the slots that were
aggregated, each slot carrying (batch index, token, dispatch step) — plus
:class:`SimMetrics` (QPS, staleness, drops).  ``repro_torch.core.trainer``
replays the schedule with real gradients, so accuracy experiments inherit
realistic staleness patterns while staying deterministic.

Timing units are seconds; worker speed is samples/second.

A copy of ``repro.sim.cluster`` (numpy only): the same spec and seed give
the same schedule in both packages.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class ClusterSpec:
    """A shared-cluster scenario (Fig. 1 abstraction)."""

    num_workers: int
    base_speed: float = 10_000.0       # samples/s of a healthy worker
    straggler_frac: float = 0.0        # fraction of workers that are slow
    straggler_slowdown: float = 4.0    # slow worker = base/slowdown
    jitter: float = 0.1                # lognormal sigma on per-batch time
    time_varying: bool = False         # sinusoidal contention (Fig. 1 day)
    contention_period: float = 200.0
    contention_depth: float = 0.6      # max fractional slowdown at peak
    allreduce_latency: float = 0.05    # sync-mode collective cost (s)
    ps_roundtrip: float = 0.01         # PS pull+push latency (s)
    ps_throughput: float = 0.0         # PS service rate (pushes/s); 0 = inf.
                                       # With a finite PS, high-concurrency
                                       # modes cap out — this is what makes
                                       # sync WIN on a vacant cluster (Fig. 1)
    failure_rate: float = 0.0          # P(worker crashes during a batch)
    recovery_time: float = 5.0         # seconds before a crashed worker
                                       # rejoins (its token is lost, Alg. 1)
    seed: int = 0

    def worker_speeds(self, rng: np.random.Generator) -> np.ndarray:
        speeds = np.full(self.num_workers, self.base_speed)
        n_slow = int(round(self.straggler_frac * self.num_workers))
        if n_slow:
            slow = rng.choice(self.num_workers, n_slow, replace=False)
            speeds[slow] = self.base_speed / self.straggler_slowdown
        return speeds

    def speed_at(self, speeds: np.ndarray, worker: int, t: float,
                 rng: np.random.Generator) -> float:
        s = speeds[worker]
        if self.time_varying:
            phase = 2 * math.pi * (t / self.contention_period
                                   + worker / self.num_workers)
            s = s * (1.0 - self.contention_depth
                     * 0.5 * (1 + math.sin(phase)))
        if self.jitter:
            s = s / rng.lognormal(0.0, self.jitter)
        return max(s, 1e-3)


@dataclass(frozen=True)
class Slot:
    batch_index: int
    token: int            # GBA token (= scheduled step); == dispatch for others
    dispatch_step: int    # global step whose params the gradient was taken at
    weight: float = 1.0   # aggregation weight after decay (0 = dropped)


@dataclass
class SimMetrics:
    mode: str
    wall_time: float = 0.0
    samples: int = 0
    num_global_steps: int = 0
    dropped_batches: int = 0
    lost_batches: int = 0              # worker failures (token disappeared)
    staleness_sum: float = 0.0
    staleness_max: int = 0
    staleness_count: int = 0
    worker_rates: list = field(default_factory=list)  # samples/s per worker

    @property
    def qps(self) -> float:
        return self.samples / self.wall_time if self.wall_time else 0.0

    @property
    def avg_staleness(self) -> float:
        return (self.staleness_sum / self.staleness_count
                if self.staleness_count else 0.0)


@dataclass
class Schedule:
    mode: str
    local_batch: int
    steps: list[list[Slot]] = field(default_factory=list)
    metrics: SimMetrics | None = None

    @property
    def max_dispatch_lag(self) -> int:
        lag = 0
        for k, slots in enumerate(self.steps):
            for s in slots:
                lag = max(lag, k - s.dispatch_step)
        return lag


def _sync_schedule(spec: ClusterSpec, num_batches: int, local_batch: int,
                   rng: np.random.Generator) -> Schedule:
    """AR synchronous training: N workers, barrier per step."""
    N = spec.num_workers
    speeds = spec.worker_speeds(rng)
    sched = Schedule("sync", local_batch)
    m = SimMetrics("sync")
    t = 0.0
    b = 0
    k = 0
    per_worker_time = np.zeros(N)
    while b + N <= num_batches:
        durs = [local_batch / spec.speed_at(speeds, w, t, rng)
                for w in range(N)]
        per_worker_time += np.asarray(durs)
        step_time = max(durs) + spec.allreduce_latency
        t += step_time
        sched.steps.append(
            [Slot(b + w, k, k) for w in range(N)])
        b += N
        k += 1
        m.samples += N * local_batch
        m.staleness_count += N
    m.wall_time = t
    m.num_global_steps = k
    if k:
        m.worker_rates = list(local_batch * k / np.maximum(per_worker_time,
                                                           1e-9))
    sched.metrics = m
    return sched


def _ps_schedule(spec: ClusterSpec, mode: str, num_batches: int,
                 local_batch: int, rng: np.random.Generator, *,
                 buffer_size: int = 1, iota: int = 0, b1: int = 0,
                 b3: int = 0) -> Schedule:
    """Event-driven PS modes: async / bsp / hop_bs / gba."""
    N = spec.num_workers
    speeds = spec.worker_speeds(rng)
    sched = Schedule(mode, local_batch)
    m = SimMetrics(mode)
    # (finish_time, worker, batch_index, token, dispatch_step)
    events: list[tuple[float, int, int, int, int]] = []
    next_batch = 0
    k = 0                       # global step (number of applies)
    buffer: list[tuple[int, int, int]] = []   # (batch, token, dispatch)
    completed = np.zeros(N, dtype=np.int64)   # per-worker finished batches
    blocked: list[int] = []
    t = 0.0
    ps_free = 0.0   # serialized PS service (finite ps_throughput)

    def dispatch(w: int, now: float):
        nonlocal next_batch
        if next_batch >= num_batches:
            return
        token = next_batch // buffer_size if mode == "gba" else k
        dur = (local_batch / spec.speed_at(speeds, w, now, rng)
               + spec.ps_roundtrip)
        heapq.heappush(events, (now + dur, w, next_batch, token, k))
        next_batch += 1

    for w in range(N):
        dispatch(w, 0.0)

    while events:
        t, w, batch, token, disp = heapq.heappop(events)
        # worker failure: the gradient (and its token) simply disappears;
        # Alg. 1 — the worker drops its state and rejoins after recovery
        if spec.failure_rate and rng.uniform() < spec.failure_rate:
            m.lost_batches += 1
            dispatch(w, t + spec.recovery_time)
            continue
        if spec.ps_throughput:
            # push is serviced by the PS serially; the worker itself is
            # not blocked (non-blocking push, Alg. 1)
            ps_free = max(t, ps_free) + 1.0 / spec.ps_throughput
            t_apply = ps_free
        else:
            t_apply = t
        completed[w] += 1
        buffer.append((batch, token, disp))
        if len(buffer) >= buffer_size:
            slots = []
            for (bi, tok, dp) in buffer:
                # Hop-BS's staleness is the worker-version gap its bound b1
                # controls (that is what the paper's Tab. 5.3 reports); the
                # token modes measure global-step data staleness.
                stale = (int(completed.max() - completed[w]) if mode ==
                         "hop_bs" else k - tok)
                if mode == "gba" and stale > iota:
                    slots.append(Slot(bi, tok, dp, weight=0.0))
                    m.dropped_batches += 1
                else:
                    slots.append(Slot(bi, tok, dp, weight=1.0))
                    m.staleness_sum += max(stale, 0)
                    m.staleness_max = max(m.staleness_max, max(stale, 0))
                    m.staleness_count += 1
                m.samples += local_batch
            sched.steps.append(slots)
            buffer.clear()
            k += 1
            # hop_bs: unblock workers now within the staleness bound
            if mode == "hop_bs":
                still: list[int] = []
                for bw in blocked:
                    if completed[bw] - completed.min() <= b1:
                        dispatch(bw, t)
                    else:
                        still.append(bw)
                blocked = still
        # re-dispatch this worker
        if mode == "hop_bs" and completed[w] - completed.min() > b1:
            blocked.append(w)
        else:
            dispatch(w, t)

    m.wall_time = max(t, ps_free)
    m.num_global_steps = k
    if m.wall_time > 0:
        m.worker_rates = list(completed * local_batch / m.wall_time)
    sched.metrics = m
    return sched


def _hop_bw_schedule(spec: ClusterSpec, num_batches: int, local_batch: int,
                     rng: np.random.Generator, b3: int) -> Schedule:
    """Backup workers: synchronized rounds of N, slowest b3 dropped."""
    N = spec.num_workers
    speeds = spec.worker_speeds(rng)
    sched = Schedule("hop_bw", local_batch)
    m = SimMetrics("hop_bw")
    t = 0.0
    b = 0
    k = 0
    while b + N <= num_batches:
        durs = np.array([local_batch / spec.speed_at(speeds, w, t, rng)
                         for w in range(N)])
        cutoff = np.partition(durs, N - b3 - 1)[N - b3 - 1] if b3 else durs.max()
        t += cutoff + spec.ps_roundtrip
        slots = []
        order = np.argsort(durs)
        for rank, w in enumerate(order):
            kept = rank < N - b3
            slots.append(Slot(b + int(w), k, k, weight=1.0 if kept else 0.0))
            if kept:
                m.samples += local_batch
                m.staleness_count += 1
            else:
                m.dropped_batches += 1
        sched.steps.append(slots)
        b += N
        k += 1
    m.wall_time = t
    m.num_global_steps = k
    sched.metrics = m
    return sched


def simulate(spec: ClusterSpec, mode: str, num_batches: int,
             local_batch: int, *, buffer_size: int = 1, iota: int = 4,
             b1: int = 2, b2: int = 20, b3: int = 0) -> Schedule:
    """Run one scenario.  ``buffer_size`` is GBA's M; ``b2`` is BSP's
    aggregation count; hyper-parameter names follow Tab. 5.1."""
    rng = np.random.default_rng(spec.seed)
    if mode == "sync":
        return _sync_schedule(spec, num_batches, local_batch, rng)
    if mode == "hop_bw":
        return _hop_bw_schedule(spec, num_batches, local_batch, rng, b3)
    if mode == "async":
        return _ps_schedule(spec, "async", num_batches, local_batch, rng,
                            buffer_size=1)
    if mode == "bsp":
        return _ps_schedule(spec, "bsp", num_batches, local_batch, rng,
                            buffer_size=b2)
    if mode == "hop_bs":
        return _ps_schedule(spec, "hop_bs", num_batches, local_batch, rng,
                            buffer_size=1, b1=b1)
    if mode == "gba":
        return _ps_schedule(spec, "gba", num_batches, local_batch, rng,
                            buffer_size=buffer_size, iota=iota)
    raise ValueError(f"unknown mode {mode!r}")
