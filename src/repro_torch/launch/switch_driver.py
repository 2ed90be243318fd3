"""Tuning-free sync<->async switching on the port's real steps.

Counterpart of ``repro.launch.switch_driver``.  The paper's headline claim
(Fig. 6): because GBA holds the global batch and the token-control rule
needs no retuning, a job can switch between synchronous all-reduce
training and asynchronous GBA training mid-run, following the cluster's
state.  ``core.autoswitch`` decides *when*; this module is the harness
that *does* it:

* **sync mode** runs :func:`repro_torch.core.gba_shard_map.make_gba_psum_step`,
  the pytree all-reduce step with Adagrad (``sync_impl="psum"``), or the
  uncompressed worker-parallel step with all-fresh tokens
  (``sync_impl="fused"``, the degenerate form the parity tests use as a
  bit-exactness oracle);
* **async mode** runs the token-controlled, layer-grouped
  worker-parallel step
  (:func:`~repro_torch.core.gba_shard_map.make_gba_fused_psum_step`, one
  ``gba_apply`` launch per shard), optionally over the quantized wire
  (its warmup and compressed steps);
* a simulated-clock event loop (the timing vocabulary of ``sim.cluster``)
  drives per-worker pulls and pushes under a
  :class:`repro_torch.sim.faults.FaultPlan` (straggler windows, transient
  crashes with token loss and timed recovery (Alg. 1), telemetry-scrape
  dropouts, async apply failures) and feeds per-worker completion rates
  to an :class:`~repro_torch.core.autoswitch.AutoSwitchController`.

The W workers and W shards run in one process on one device
(``repro_torch.distributed.inprocess``, the default) or over R
``torch.distributed`` ranks (a ``process_group.ProcessGroupBackend``,
``world=``), W / R workers and shards on each: the driver takes
``workers=W`` and ``world`` where the reference takes a mesh.  Over
ranks, async mode keeps each rank's run of the flat state and its
workers' wire rows, psum sync mode the whole tree and Adagrad state on
every rank (the reference's ``P()``); a rank uploads its own workers'
slots alone.  Everything the simulated clock, the fault injector, the
controller and the breaker read is the same on every rank (the plan, the
seed, the losses every rank gathers), so every rank takes the same
branches and returns the same :class:`SwitchResult`.

Switch protocol:

1. **drain**: in-flight worker batches are cancelled; their tokens are
   discarded (counted in ``SwitchResult.drained``) and the batches
   requeued, so no data is lost across the swap;
2. **state carryover**: the canonical training state is the layout's flat
   (param, accum) pair.  ``sync_impl="fused"`` shares it between modes;
   ``sync_impl="psum"`` converts pytree params and Adagrad accumulator to
   and from flat vectors with :func:`tree_to_flat` and
   :func:`flat_to_tree` (padding positions carry param 0 and accumulator
   ``initial_accum``, as in a run that never switched); over ranks the
   flat -> tree direction first gathers the ranks' runs, and tree -> flat
   keeps the rank's own run.  With ``verify_swap`` every swap (on every
   rank) round-trips the conversion into storage of its own and raises on
   any bit difference.  Exactly one representation is live at a time: the
   other is freed at the swap;
3. **token reissue**: sync mode stamps every participating slot with the
   current global step; async dispatches stamp the pull-time step.  A
   worker excluded from the sync barrier (dead, or timed out past the
   retry budget) contributes a **tombstone** slot: token ``gstep - iota -
   1``, which Eq. (1) weighs by exactly zero;
4. **compression warmup re-entry**: each entry into async mode zeroes the
   wire state and restarts the warmup counter.

Graceful degradation: per-worker pull timeouts with bounded retry and
backoff; a crashed worker is discovered by one timeout burst and excluded
from the barrier until its recovery time; ``breaker_threshold``
consecutive async apply failures trip a fallback-to-sync circuit breaker.

The steps update their state in place, where the reference's return new
arrays, so: every run starts from clones of the initial params; a step
whose loss is not finite skips its apply (params and accumulator stay as
they were, as the reference discards them); and the final flat state is
returned as copies.  One difference remains: the quantized wire writes
its state in place before the loss is known, so after such a step the
driver zeroes the wire state and re-enters the warmup, where the
reference keeps the previous wire state.

    python -m repro_torch.launch.switch_driver --workers 4 --batches 240 \\
        --plan strained --compare-sync --json [--ranks R] [--device cuda]

``--ranks R`` runs the demo on R ``torch.distributed`` ranks of W / R
workers each (gloo with ``--device cpu``, each rank running this
process's intra-op threads, NCCL one rank a card with ``cuda``); each
rank builds the demo model itself, and rank 0 prints.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import jax_random
from repro_torch.core.autoswitch import AutoSwitchController
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import TILE, ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.distributed import inprocess, process_group
from repro_torch.kernels.ref import EPS
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim import adagrad, tree_map
from repro_torch.sim.cluster import ClusterSpec
from repro_torch.sim.faults import FaultInjector, FaultPlan


# ---------------------------------------------------------------------------
# state carryover: pytree params / Adagrad accumulator <-> canonical flat
# ---------------------------------------------------------------------------

def pad_mask(layout: ShardedFlatLayout) -> torch.Tensor:
    """(padded_total,) float32 on the CPU: 1.0 where a real parameter
    element lives, 0.0 in tile and shard padding."""
    ones = layout.unflatten([torch.ones(s, dtype=torch.float32)
                             for s in layout.shapes])
    return layout.ravel(ones)


def tree_to_flat(layout: ShardedFlatLayout, params: Any, accum_tree: Any,
                 *, initial_accum: float = 0.1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(params tree, Adagrad accumulator tree) -> new flat (param, accum)
    float32 vectors.  Padding gets param 0 and accumulator
    ``initial_accum``: the state a run that never switched carries there
    (padding gradient is zero, so Adagrad never moves it), which makes a
    sync -> async -> sync round trip bit-exact against such a run."""
    return (layout.ravel(params),
            layout.ravel(accum_tree, pad=initial_accum))


def flat_to_tree(layout: ShardedFlatLayout, param_flat: torch.Tensor,
                 accum_flat: torch.Tensor) -> tuple[Any, dict]:
    """Flat (param, accum) -> (params tree, Adagrad state), in storage of
    their own.  Params take their leaves' dtypes; the accumulator stays
    float32, the optimizer's dtype, even for a bfloat16 model."""
    return (layout.unravel(param_flat),
            {"accum": layout.unravel(accum_flat, torch.float32)})


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


# ---------------------------------------------------------------------------
# configuration / results
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SwitchConfig:
    """Knobs of the switching harness.

    ``push_timeout`` and ``backoff`` default to ``None``, that is 8x and
    2x the healthy pull (``local_batch / spec.base_speed +
    spec.ps_roundtrip``), so a 4x straggler never times out but a dead
    worker is discovered within one bounded retry burst.  Adagrad's
    epsilon is the ``gba_apply`` kernel's, ``kernels.ref.EPS``, in both
    modes (the reference's ``eps`` field, which no caller sets)."""
    local_batch: int = 256
    iota: int = 4               # Eq. (1) staleness tolerance
    lr: float = 0.05
    initial_accum: float = 0.1  # Adagrad's initial accumulator
    decide_every: int = 4       # global steps per telemetry decision
    min_dwell: int = 2          # controller cooldown, in decisions
    push_timeout: float | None = None   # simulated seconds a pull attempt
    max_retries: int = 2        # extra pull attempts before exclusion
    backoff: float | None = None        # extra wait between attempts
    breaker_threshold: int = 3  # consecutive async apply failures ->
                                # forced fallback to sync
    sync_impl: str = "psum"     # "psum" | "fused" (module docstring)
    verify_swap: bool = True    # bit-exact round-trip check at each swap

    def __post_init__(self):
        if self.sync_impl not in ("psum", "fused"):
            raise ValueError(f"sync_impl must be 'psum' or 'fused', "
                             f"got {self.sync_impl!r}")
        if self.local_batch < 1:
            raise ValueError(f"local_batch must be >= 1, "
                             f"got {self.local_batch}")
        if self.decide_every < 1:
            raise ValueError(f"decide_every must be >= 1, "
                             f"got {self.decide_every}")
        if self.breaker_threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, "
                             f"got {self.breaker_threshold}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")


@dataclass(frozen=True)
class GlobalStep:
    """One replayable global step: per-slot tokens and batch indices
    (batch index < 0 = tombstone slot: zero batch, weight-0 token)."""
    tokens: tuple[int, ...]
    batches: tuple[int, ...]


@dataclass
class SwitchResult:
    """What one driver run measured.  ``param_flat`` and ``accum_flat`` are
    host copies of the final canonical flat state (converted from the tree
    if the run ended in psum sync mode), so two runs compare bit for bit
    whichever mode they ended in."""
    wall_time: float = 0.0      # simulated seconds
    samples: int = 0            # aggregated (weight-1) samples
    num_global_steps: int = 0
    switch_count: int = 0
    time_to_first_switch_steps: int | None = None
    mode_timeline: list = field(default_factory=list)  # (gstep, t, mode)
    mode_steps: dict = field(default_factory=dict)     # mode -> gsteps
    mode_time: dict = field(default_factory=dict)      # mode -> seconds
    losses: list = field(default_factory=list)
    crashes: int = 0
    rejoins: int = 0
    timeouts: int = 0
    lost_batches: int = 0       # tokens lost to crashes (Alg. 1)
    dropped_batches: int = 0    # Eq. (1) weight-0 slots (real, stale)
    tombstones: int = 0         # synthetic weight-0 slots (exclusions)
    drained: int = 0            # in-flight tokens discarded at swaps
    stalled_barriers: int = 0   # sync rounds with zero live workers
    apply_failures: int = 0
    breaker_trips: int = 0
    dropped_scrapes: int = 0
    swaps_verified: int = 0
    warm_steps: int = 0         # async steps run on the warmup step
    param_flat: np.ndarray | None = None
    accum_flat: np.ndarray | None = None
    controller_summary: dict | None = None

    @property
    def qps(self) -> float:
        return self.samples / self.wall_time if self.wall_time else 0.0

    def to_json(self) -> dict:
        def py(v):
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            if isinstance(v, dict):
                return {k: py(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [py(x) for x in v]
            return v
        out = {k: py(v) for k, v in self.__dict__.items()
               if k not in ("param_flat", "accum_flat", "losses")}
        out["qps"] = py(self.qps)
        out["final_loss"] = self.losses[-1] if self.losses else None
        return out


class _RunState:
    """Mutable per-run bookkeeping: mode, live training state, event heap,
    telemetry window, the counters that land in :class:`SwitchResult`."""

    def __init__(self, num_workers: int):
        self.mode = "sync"
        self.finished = False
        # training state: exactly one representation is live at a time
        self.params = None          # tree (psum sync mode)
        self.opt = None             # {"accum": tree}
        self.pf = None              # flat params (the flat modes)
        self.af = None              # flat accumulator
        self.wire = None
        self.warm_count = 0
        # simulated clock / data
        self.t = 0.0
        self.gstep = 0
        self.inj = None             # set by run(); None in run_schedule
        self.num_batches = 0
        self.next_batch = 0
        self.requeue: list[int] = []
        self.heap: list = []        # async events
        self.seq = itertools.count()
        self.down: set[int] = set()
        self.breaker = 0
        # telemetry window
        self.win_completions = np.zeros(num_workers)
        self.win_busy = np.zeros(num_workers)
        self.result = SwitchResult()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class SwitchDriver:
    """Runs the sync and async steps under a fault plan with live mode
    switching.  The steps are built once in the constructor; :meth:`run`
    (event-driven simulation) and :meth:`run_schedule` (fixed schedule
    replay) can each be called repeatedly, for example once in
    ``mode="auto"`` and once in ``mode="sync"`` on the same plan, and every
    run starts from the same initial params.

    ``params`` (a dict tree on the device the steps run on) and
    ``loss_fn(params, batch) -> scalar`` define the model; ``batch_fn(i)``
    gives local batch ``i`` as a dict of numpy arrays with leading axis
    ``cfg.local_batch``.  ``world`` holds the collectives
    (``distributed.inprocess``, or this rank's
    ``process_group.ProcessGroupBackend``, every rank constructing its
    driver from the same arguments)."""

    def __init__(self, workers: int, loss_fn: Callable, params: Any, *,
                 spec: ClusterSpec, plan: FaultPlan,
                 cfg: SwitchConfig = SwitchConfig(),
                 batch_fn: Callable[[int], dict],
                 compress: CompressionPolicy | None = None,
                 layout: ShardedFlatLayout | None = None,
                 group_by=None, tile: int | None = None, world=inprocess):
        self.cfg = cfg
        self.m = workers
        self.world = world
        self.mine = world.workers(workers)
        if spec.num_workers != self.m or plan.num_workers != self.m:
            raise ValueError(
                f"{self.m} workers; spec has {spec.num_workers} workers, "
                f"plan has {plan.num_workers}")
        self.spec, self.plan = spec, plan
        self.loss_fn, self.batch_fn = loss_fn, batch_fn
        self.compress = (compress if compress is not None
                         and compress.stateful else None)
        if layout is None:
            layout = ShardedFlatLayout.from_params(
                params, self.m, tile or TILE, group_by=group_by)
        if layout.num_shards != self.m:
            raise ValueError(f"layout has {layout.num_shards} shards, there "
                             f"are {self.m} workers")
        self.layout = layout
        self._params0 = params
        self.device = next(iter(tree_paths(params)))[1].device
        # resolved timeout and backoff (simulated seconds): a healthy pull
        # costs compute and the PS round trip, so both are budgeted
        base_dur = cfg.local_batch / spec.base_speed + spec.ps_roundtrip
        self.push_timeout = (cfg.push_timeout if cfg.push_timeout
                             is not None else 8.0 * base_dur)
        self.backoff = (cfg.backoff if cfg.backoff is not None
                        else 2.0 * base_dur)
        # the steps: async = the wire step pair, sync = the uncompressed
        # wire step on the shared flat state, or the pytree psum step
        def wire_step(compress, warm):
            return make_gba_fused_psum_step(
                self.m, loss_fn, layout, iota=cfg.iota, lr=cfg.lr,
                compress=compress, warm=warm, world=world)

        self._fused_plain = wire_step(None, False)
        if self.compress is not None:
            self._fused_warm = wire_step(self.compress, True)
            self._fused_main = wire_step(self.compress, False)
        if cfg.sync_impl == "psum":
            self._opt = adagrad(cfg.lr, eps=EPS,
                                initial_accum=cfg.initial_accum)
            self._sync_step = make_gba_psum_step(self.m, loss_fn, self._opt,
                                                 cfg.iota, world=world)
        # zero batch of tombstone slots (its weight is exactly 0, so its
        # content never reaches the params; zeros keep losses finite)
        tmpl = {k: np.asarray(v) for k, v in batch_fn(0).items()}
        lead = {tmpl[min(tmpl)].shape[0]}
        if lead != {cfg.local_batch}:
            raise ValueError(
                f"batch_fn leading dim {lead} != local_batch "
                f"{cfg.local_batch}")
        self._zeros_batch = {k: np.zeros_like(v) for k, v in tmpl.items()}

    # -- state management ---------------------------------------------------
    def _fresh_state(self, mode: str) -> _RunState:
        """A run's state, from copies of the initial params: the steps
        write in place, and every run starts where the first did."""
        st = _RunState(self.m)
        st.mode = mode
        if mode == "sync" and self.cfg.sync_impl == "psum":
            st.params = tree_map(torch.clone, self._params0)
            st.opt = self._opt.init(self._params0)
        else:
            st.pf = self._own_run(self.layout.ravel(self._params0))
            st.af = torch.full_like(st.pf, self.cfg.initial_accum)
            if mode == "gba":
                self._reset_wire(st)
        return st

    def _own_run(self, flat: torch.Tensor) -> torch.Tensor:
        """This process's run of a whole shard-major vector: ``flat``
        itself where it holds every shard, else a copy of its shards'
        columns, so the whole vector can be freed."""
        if len(self.mine) == self.m:
            return flat
        ss = self.layout.shard_size
        return flat[self.mine[0] * ss:(self.mine[-1] + 1) * ss].clone()

    def _reset_wire(self, st: _RunState) -> None:
        """Compression warmup re-entry: zero wire state, restart the
        warmup counter."""
        st.warm_count = 0
        st.wire = None
        if self.compress is not None:
            st.wire = self.compress.init_wire_state(
                self.layout, len(self.mine), self.device)

    def _swap(self, st: _RunState, new_mode: str, controller=None) -> None:
        """The switch protocol: drain in-flight work, convert the state
        (verified bit-exact when ``verify_swap``), reissue from the
        requeue, re-enter the compression warmup."""
        if new_mode == st.mode:
            return
        r = st.result
        if st.mode == "gba":
            # drain: discard in-flight tokens, requeue their batches
            for ev in st.heap:
                if ev[2] == "push":
                    st.requeue.append(ev[4])
                    r.drained += 1
            st.heap = []
            st.wire = None
        if self.cfg.sync_impl == "psum":
            ia = self.cfg.initial_accum
            if new_mode == "gba":       # tree -> flat
                pf, af = tree_to_flat(self.layout, st.params,
                                      st.opt["accum"], initial_accum=ia)
                if self.cfg.verify_swap:
                    # flat -> tree must give the source tree bit for bit
                    # (float32 holds every bfloat16 value exactly)
                    p2, o2 = flat_to_tree(self.layout, pf, af)
                    self._check_equal(st.params, p2, "params")
                    self._check_equal(st.opt["accum"], o2["accum"], "accum")
                    del p2, o2
                    r.swaps_verified += 1
                st.pf, st.af = self._own_run(pf), self._own_run(af)
                del pf, af
                st.params = st.opt = None
            else:                       # flat -> tree
                pf = self.world.gather_flat(st.pf)
                af = self.world.gather_flat(st.af)
                st.pf = st.af = None
                params, opt = flat_to_tree(self.layout, pf, af)
                if self.cfg.verify_swap:
                    # tree -> flat must give the source vectors.  The
                    # accumulator is exact always; a bfloat16 model's
                    # params round to the model dtype here (sync mode has
                    # no wider home for them), so the param check applies
                    # to a float32 model only.
                    pf2, af2 = tree_to_flat(self.layout, params,
                                            opt["accum"], initial_accum=ia)
                    self._check_equal(af, af2, "accum")
                    if all(d == torch.float32 for d in self.layout.dtypes):
                        self._check_equal(pf, pf2, "params")
                    del pf2, af2
                    r.swaps_verified += 1
                del pf, af
                st.params, st.opt = params, opt
        # sync_impl="fused": the flat state is shared, nothing to convert
        if new_mode == "gba":
            self._reset_wire(st)
            if st.inj is not None:      # event-driven run, not a replay
                self._enter_async(st)
        st.mode = new_mode
        r.switch_count += 1
        if r.time_to_first_switch_steps is None:
            r.time_to_first_switch_steps = st.gstep
        r.mode_timeline.append((st.gstep, st.t, new_mode))

    @staticmethod
    def _check_equal(a, b, what: str) -> None:
        """Bit-exactness of the carryover: the round-tripped state, in
        storage of its own, must reproduce the source exactly."""
        def leaves(t):
            return ([x for _, x in tree_paths(t)]
                    if isinstance(t, (dict, list)) else [t])

        for x, y in zip(leaves(a), leaves(b), strict=True):
            if x.numel() and x.data_ptr() == y.data_ptr():
                raise RuntimeError(f"switch carryover: the {what} check "
                                   f"compares a tensor with itself")
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(
                    _bits(x), _bits(y)):
                raise RuntimeError(f"switch carryover: {what} round trip "
                                   "is not bit-exact")

    def _canonical_flat(self, st: _RunState
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of the run's final flat (param, accum), the whole
        vectors on every rank."""
        if st.pf is not None:
            pf = self.world.gather_flat(st.pf)
            af = self.world.gather_flat(st.af)
        else:
            pf, af = tree_to_flat(self.layout, st.params, st.opt["accum"],
                                  initial_accum=self.cfg.initial_accum)
        return (pf.to("cpu", copy=True).numpy(),
                af.to("cpu", copy=True).numpy())

    # -- step execution -----------------------------------------------------
    def _put_batch(self, slot_batches: list) -> dict:
        """The slots of the workers held here, on the device, one after
        another: the rows the steps take."""
        held = [slot_batches[w] for w in self.mine]
        return {k: torch.from_numpy(np.concatenate(
            [np.asarray(b[k]) for b in held], axis=0)).to(self.device)
            for k in held[0]}

    def _exec(self, st: _RunState, tokens: np.ndarray,
              slot_batches: list) -> float:
        """Run one global step of the current mode.  Returns the loss; a
        loss that is not finite commits nothing to params and
        accumulator (the caller counts the failure)."""
        batch = self._put_batch(slot_batches)
        tok = torch.from_numpy(tokens.astype(np.int32)).to(self.device)
        if st.mode == "sync" and self.cfg.sync_impl == "psum":
            params, opt, loss = self._sync_step(st.params, st.opt, batch,
                                                tok, st.gstep)
            loss = float(loss)
            if math.isfinite(loss):
                st.params, st.opt = params, opt
            return loss
        if st.mode == "sync" or self.compress is None:
            *_, loss = self._fused_plain(st.pf, st.af, batch, tok, st.gstep)
            return float(loss)
        warm = st.warm_count < self.compress.warmup_steps
        fn = self._fused_warm if warm else self._fused_main
        _, _, loss, _ = fn(st.pf, st.af, batch, tok, st.gstep, st.wire)
        loss = float(loss)
        if math.isfinite(loss):
            st.warm_count += 1
            if warm:
                st.result.warm_steps += 1
        elif not warm or self.compress.scheme == "onebit":
            # the step wrote the wire state in place: start it over
            self._reset_wire(st)
        return loss

    # -- batch bookkeeping --------------------------------------------------
    def _take_batch(self, st: _RunState, num_batches: int) -> int | None:
        if st.requeue:
            return st.requeue.pop(0)
        if st.next_batch < num_batches:
            b = st.next_batch
            st.next_batch += 1
            return b
        return None

    def _has_batches(self, st: _RunState, num_batches: int) -> bool:
        return bool(st.requeue) or st.next_batch < num_batches

    # -- sync mode: one barrier round ---------------------------------------
    def _sync_round(self, st: _RunState, inj: FaultInjector,
                    num_batches: int) -> None:
        r, cfg, m = st.result, self.cfg, self.m
        t0 = st.t
        # health check: recovered workers rejoin the barrier
        for w in sorted(st.down):
            if not inj.is_down(w, t0):
                st.down.discard(w)
                r.rejoins += 1
        lat = np.zeros(m)
        part: dict[int, int] = {}
        requeue_back: list[int] = []
        for w in range(m):
            if w in st.down:
                continue            # excluded: no probe, tombstone slot
            b = self._take_batch(st, num_batches)
            if b is None:
                continue            # data exhausted: idle, tombstone
            dur = inj.duration(w, t0, cfg.local_batch) \
                + self.spec.ps_roundtrip
            ev = inj.crash_between(w, t0, t0 + dur)
            if ev is not None:
                # the pull hangs: one bounded retry burst discovers the
                # dead worker, then it is excluded until recovery; the
                # barrier never waits past the timeout budget
                lat[w] = ((1 + cfg.max_retries) * self.push_timeout
                          + cfg.max_retries * self.backoff)
                r.timeouts += 1
                r.crashes += 1
                st.down.add(w)
                requeue_back.append(b)
                continue
            if dur > self.push_timeout:
                # alive but slower than the timeout: retry with backoff,
                # give up (exclude this round only) past the budget
                cost, ok = self.push_timeout, False
                for _ in range(cfg.max_retries):
                    cost += self.backoff
                    d2 = inj.duration(w, t0 + cost, cfg.local_batch) \
                        + self.spec.ps_roundtrip
                    if d2 <= self.push_timeout:
                        cost += d2
                        ok = True
                        break
                    cost += self.push_timeout
                lat[w] = cost
                if ok:
                    part[w] = b
                else:
                    r.timeouts += 1
                    requeue_back.append(b)
                continue
            lat[w] = dur
            part[w] = b
        st.requeue.extend(requeue_back)
        if not part:
            if st.down and self._has_batches(st, num_batches):
                # every live worker idle and data remains: jump the
                # barrier clock to the earliest rejoin, no deadlock
                r.stalled_barriers += 1
                st.t = max(st.t, float(min(inj.down_until[w]
                                           for w in st.down)))
            else:
                st.finished = True
            return
        # tombstone token: Eq. (1) weighs it by exactly zero, so excluded
        # slots change neither params nor loss
        tokens = np.full(m, st.gstep - cfg.iota - 1, np.int64)
        slot_batches: list = [self._zeros_batch] * m
        for w, b in part.items():
            tokens[w] = st.gstep
            slot_batches[w] = self.batch_fn(b)
        r.tombstones += m - len(part)
        loss = self._exec(st, tokens, slot_batches)
        step_time = float(lat.max()) + self.spec.allreduce_latency
        st.t = t0 + step_time
        if not math.isfinite(loss):
            r.apply_failures += 1
            return
        st.gstep += 1
        r.num_global_steps += 1
        r.mode_steps["sync"] = r.mode_steps.get("sync", 0) + 1
        r.samples += len(part) * cfg.local_batch
        r.losses.append(loss)
        for w in part:
            st.win_completions[w] += 1
            st.win_busy[w] += lat[w]

    # -- async mode: dispatch / fill / apply --------------------------------
    def _dispatch(self, st: _RunState, inj: FaultInjector, w: int,
                  now: float, num_batches: int) -> None:
        b = self._take_batch(st, num_batches)
        if b is None:
            return
        dur = inj.duration(w, now, self.cfg.local_batch) \
            + self.spec.ps_roundtrip
        heapq.heappush(st.heap, (now + dur, next(st.seq), "push", w, b,
                                 st.gstep, now))

    def _enter_async(self, st: _RunState) -> None:
        """(Re)build the event heap on entry into async mode: live workers
        dispatch at once, down workers get a rejoin event at their
        recovery time."""
        inj = st.inj
        for w in range(self.m):
            if w in st.down:
                heapq.heappush(st.heap, (float(inj.down_until[w]),
                                         next(st.seq), "rejoin", w, -1,
                                         -1, 0.0))
            else:
                self._dispatch(st, inj, w, st.t, st.num_batches)

    def _async_round(self, st: _RunState, inj: FaultInjector,
                     num_batches: int, controller) -> None:
        r, cfg, m = st.result, self.cfg, self.m
        pending: list[tuple[int, int, int]] = []
        guard = 0
        while len(pending) < m:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("switch driver stalled: async buffer "
                                   "fill made no progress")
            if not st.heap:
                break               # data exhausted: flush a partial fill
            time_, _, kind, w, b, tok, t_disp = heapq.heappop(st.heap)
            if kind == "rejoin":
                st.t = max(st.t, time_)
                if w in st.down:
                    st.down.discard(w)
                    r.rejoins += 1
                self._dispatch(st, inj, w, time_, num_batches)
                continue
            ev = inj.crash_between(w, t_disp, time_)
            if ev is not None:
                # Alg. 1: the worker's gradient and its token disappear;
                # it rejoins after recovery, and the buffer keeps filling
                # from the surviving workers
                r.crashes += 1
                r.lost_batches += 1
                st.down.add(w)
                st.t = max(st.t, ev.at)
                heapq.heappush(st.heap, (float(inj.down_until[w]),
                                         next(st.seq), "rejoin", w, -1,
                                         -1, 0.0))
                continue
            st.t = max(st.t, time_)
            pending.append((w, b, tok))
            st.win_completions[w] += 1
            st.win_busy[w] += time_ - t_disp
            self._dispatch(st, inj, w, time_, num_batches)
        if not pending:
            st.finished = True
            return
        gstep = st.gstep
        tokens = np.full(m, gstep - cfg.iota - 1, np.int64)
        slot_batches: list = [self._zeros_batch] * m
        for i, (w, b, tok) in enumerate(pending):
            tokens[i] = tok
            slot_batches[i] = self.batch_fn(b)
        r.tombstones += m - len(pending)
        if inj.apply_fails(gstep):
            # PS write dropped: gradients lost, params not committed
            r.apply_failures += 1
            self._breaker_tick(st, controller)
            return
        loss = self._exec(st, tokens, slot_batches)
        if not math.isfinite(loss):
            r.apply_failures += 1
            self._breaker_tick(st, controller)
            return
        st.breaker = 0
        kept = sum(1 for i in range(len(pending))
                   if gstep - tokens[i] <= cfg.iota)
        r.dropped_batches += len(pending) - kept
        r.samples += kept * cfg.local_batch
        st.gstep += 1
        r.num_global_steps += 1
        r.mode_steps["gba"] = r.mode_steps.get("gba", 0) + 1
        r.losses.append(loss)

    def _breaker_tick(self, st: _RunState, controller) -> None:
        """Consecutive async apply failures trip the fallback-to-sync
        circuit breaker; forcing the controller restarts its dwell window,
        so the next decisions cannot flip straight back."""
        st.breaker += 1
        if st.breaker >= self.cfg.breaker_threshold and st.mode == "gba":
            st.result.breaker_trips += 1
            st.breaker = 0
            if controller is not None:
                controller.force("sync")
            self._swap(st, "sync", controller)

    # -- telemetry ----------------------------------------------------------
    def _window_rates(self, st: _RunState) -> np.ndarray:
        """Per-worker samples/s over the window, from busy time (compute
        only, not barrier wait), so sync mode still exposes each worker's
        capability; a worker with no completions reads exactly 0, the
        controller's dead-worker marker."""
        rates = np.zeros(self.m)
        mask = st.win_busy > 0
        rates[mask] = (st.win_completions[mask] * self.cfg.local_batch
                       / st.win_busy[mask])
        return rates

    # -- entry points -------------------------------------------------------
    def run(self, num_batches: int, *, mode: str = "auto",
            controller: AutoSwitchController | None = None,
            mode_schedule: Callable[[int], str] | None = None,
            seed: int = 0) -> SwitchResult:
        """Event-driven run over ``num_batches`` local batches.

        ``mode="auto"`` lets the controller decide every ``decide_every``
        global steps from live telemetry; ``mode="sync"`` or ``"gba"``
        forces one mode (the circuit breaker can still force sync);
        ``mode_schedule`` (gstep -> mode) overrides both."""
        if mode not in ("auto", "sync", "gba"):
            raise ValueError(f"unknown mode {mode!r}")
        inj = FaultInjector(self.plan, self.spec, seed)
        if mode == "auto" and controller is None and mode_schedule is None:
            controller = AutoSwitchController(min_dwell=self.cfg.min_dwell)
        if mode != "auto":
            controller = None
        start = (mode_schedule(0) if mode_schedule is not None
                 else mode if mode != "auto" else "sync")
        st = self._fresh_state(start)
        st.inj = inj
        st.num_batches = num_batches
        if start == "gba":
            self._enter_async(st)
        last_decide = -1
        rounds = 0
        while not st.finished:
            rounds += 1
            if rounds > 1000 + 100 * num_batches:
                raise RuntimeError("switch driver stalled: no progress "
                                   f"after {rounds} rounds")
            pre_mode, pre_t = st.mode, st.t
            if st.mode == "sync":
                self._sync_round(st, inj, num_batches)
            else:
                self._async_round(st, inj, num_batches, controller)
            st.result.mode_time[pre_mode] = (
                st.result.mode_time.get(pre_mode, 0.0) + st.t - pre_t)
            if st.finished:
                break
            if mode_schedule is not None:
                want = mode_schedule(st.gstep)
                if want != st.mode:
                    self._swap(st, want)
            elif (controller is not None and st.gstep > 0
                    and st.gstep % self.cfg.decide_every == 0
                    and st.gstep != last_decide):
                last_decide = st.gstep
                rates = inj.scrape(st.t, self._window_rates(st))
                decision = controller.decide(
                    [] if rates is None else rates)
                st.win_completions[:] = 0.0
                st.win_busy[:] = 0.0
                if decision != st.mode:
                    self._swap(st, decision, controller)
        r = st.result
        r.wall_time = st.t
        r.dropped_scrapes = inj.dropped_scrapes
        r.param_flat, r.accum_flat = self._canonical_flat(st)
        if controller is not None:
            r.controller_summary = controller.summary()
        return r

    def run_schedule(self, steps: Sequence[GlobalStep],
                     modes: Sequence[str]) -> SwitchResult:
        """Replay a fixed schedule of global steps (tokens and batch
        indices per slot) through the mode steps, swapping wherever
        ``modes`` changes; no simulated clock, no faults.  The same
        schedule replayed with and without swaps gives bit-identical flat
        state with ``sync_impl="fused"`` (one step family), and agrees
        within float32 rounding with ``sync_impl="psum"``."""
        if len(steps) != len(modes):
            raise ValueError(f"{len(steps)} steps but {len(modes)} modes")
        for md in modes:
            if md not in ("sync", "gba"):
                raise ValueError(f"unknown mode {md!r}")
        st = self._fresh_state(modes[0] if steps else "sync")
        r = st.result
        for k, (gs, md) in enumerate(zip(steps, modes)):
            if md != st.mode:
                self._swap(st, md)
            if len(gs.tokens) != self.m or len(gs.batches) != self.m:
                raise ValueError(
                    f"step {k}: expected {self.m} slots, got "
                    f"{len(gs.tokens)} tokens / {len(gs.batches)} batches")
            tokens = np.asarray(gs.tokens, np.int64)
            slot_batches = [self._zeros_batch if b < 0 else self.batch_fn(b)
                            for b in gs.batches]
            r.tombstones += sum(1 for b in gs.batches if b < 0)
            loss = self._exec(st, tokens, slot_batches)
            kept = sum(1 for i, b in enumerate(gs.batches)
                       if b >= 0 and st.gstep - tokens[i] <= self.cfg.iota)
            real = sum(1 for b in gs.batches if b >= 0)
            r.dropped_batches += real - kept
            r.samples += kept * self.cfg.local_batch
            st.gstep += 1
            r.num_global_steps += 1
            r.mode_steps[md] = r.mode_steps.get(md, 0) + 1
            r.losses.append(loss)
        r.param_flat, r.accum_flat = self._canonical_flat(st)
        return r


# ---------------------------------------------------------------------------
# demo model and CLI (the Fig. 6 switching bench drives this)
# ---------------------------------------------------------------------------

def demo_model(seed: int = 0, device: str | torch.device = "cuda"):
    """A small MLP regression with leaves that are not tile multiples
    (1221-, 33- and 792-element leaves against a 2048 tile) across three
    layer groups, which exercises the padded carryover.  Its weights are
    the reference's draw of ``jax.random.PRNGKey(seed)``, reproduced in
    numpy (within a few ulps).  Returns (params, loss_fn, group_by)."""
    ks = jax_random.split(jax_random.prng_key(seed), 3)

    def draw(k, shape):
        return torch.from_numpy(np.float32(0.3) * jax_random.normal(k, shape)
                                ).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    params = {
        "l1": {"w": draw(ks[0], (37, 33)), "b": zeros(33)},
        "l2": {"w": draw(ks[1], (33, 24)), "b": zeros(24)},
        "head": {"w": draw(ks[2], (24, 5)), "b": zeros(5)},
    }

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["l1"]["w"] + p["l1"]["b"])
        h = torch.tanh(h @ p["l2"]["w"] + p["l2"]["b"])
        out = h @ p["head"]["w"] + p["head"]["b"]
        return torch.mean((out - batch["y"]) ** 2)

    return params, loss_fn, (lambda path: path[0])


def demo_batch_fn(local_batch: int):
    """Deterministic per-index batches: index ``i`` always yields the same
    (x, y), the property the parity tests rely on."""
    def batch_fn(i: int) -> dict:
        rng = np.random.default_rng(100_000 + i)
        return {"x": rng.standard_normal((local_batch, 37)
                                         ).astype(np.float32),
                "y": rng.standard_normal((local_batch, 5)
                                         ).astype(np.float32)}
    return batch_fn


def demo_plan(name: str, workers: int) -> FaultPlan:
    if name == "quiet":
        return FaultPlan.quiet(workers)
    if name == "strained":
        # the acceptance scenario: 25 % stragglers at 4x and one transient
        # crash early enough that both the auto and the forced-sync run
        # live through the outage and the rejoin
        return FaultPlan.strained(workers, straggler_frac=0.25,
                                  slowdown=4.0, crash_at=1.0,
                                  recovery=2.0)
    raise ValueError(f"unknown plan {name!r} (quiet|strained)")


def demo_spec(workers: int, seed: int = 0) -> ClusterSpec:
    """The cluster of the CLI and the LM launcher's ``--autoswitch``."""
    return ClusterSpec(num_workers=workers, base_speed=10_000.0,
                       jitter=0.05, allreduce_latency=0.005,
                       ps_roundtrip=0.001, seed=seed)


def main(argv: list[str] | None = None) -> dict | None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batches", type=int, default=240)
    ap.add_argument("--local-batch", type=int, default=256)
    ap.add_argument("--plan", default="strained",
                    choices=("quiet", "strained"))
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "sync", "gba"))
    ap.add_argument("--sync-impl", default="psum",
                    choices=("psum", "fused"))
    ap.add_argument("--decide-every", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-sync", action="store_true",
                    help="also run forced-sync on the same plan and "
                         "report speedup_vs_sync")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line (the last "
                         "line of stdout)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run on that many torch.distributed ranks of "
                         "WORKERS / RANKS workers each: gloo on the CPU, "
                         "NCCL one rank per card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.workers < 1:
        ap.error(f"--workers {args.workers}: needs 1 or more")

    if args.ranks:
        process_group.check_world(args.ranks, args.workers, args.device)
        return process_group.spawn(_demo, args.ranks, args,
                                   device=args.device,
                                   threads=torch.get_num_threads())
    return _demo(inprocess, resolve_device(args.device), args)


def _demo(world, dev: torch.device, args) -> dict:
    """The CLI's run of the demo over ``world`` (this rank's, under
    ``--ranks``) on ``dev``; prints the result and returns it."""
    import json
    params, loss_fn, group_by = demo_model(device=dev)
    cfg = SwitchConfig(local_batch=args.local_batch,
                       decide_every=args.decide_every,
                       sync_impl=args.sync_impl)
    driver = SwitchDriver(args.workers, loss_fn, params,
                          spec=demo_spec(args.workers, args.seed),
                          plan=demo_plan(args.plan, args.workers), cfg=cfg,
                          batch_fn=demo_batch_fn(args.local_batch),
                          group_by=group_by, world=world)
    res = driver.run(args.batches, mode=args.mode, seed=args.seed)
    out = res.to_json()
    out["plan"] = args.plan
    out["deadlocked"] = 0           # a stalled run raises, never returns
    if args.compare_sync:
        sync = driver.run(args.batches, mode="sync", seed=args.seed)
        out["sync_wall_time"] = sync.wall_time
        out["sync_qps"] = sync.qps
        out["sync_timeouts"] = sync.timeouts
        out["sync_rejoins"] = sync.rejoins
        out["speedup_vs_sync"] = (res.qps / sync.qps if sync.qps else
                                  float("nan"))
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
