"""Continual-training experiments (paper Sec. 5 protocol).

Counterpart of ``repro.core.continual``.  Inherit a base model, then for
each day: train on day ``d`` under a given training mode / cluster
scenario, evaluate on day ``d+1``.  Mode switching is expressed by just
changing the mode between days: the whole point of the paper is that GBA
makes this tuning-free.

The mode hyper-parameters mirror Tab. 5.1's structure at laptop scale:
sync uses ``N_s`` workers with local batch ``B_s``; GBA uses ``M`` workers
with local batch ``B_a = B_s * N_s / M`` (same global batch); the baselines
use their own knobs (b1/b2/b3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from repro_torch.configs.recsys import RecsysConfig
from repro_torch.core.trainer import GBATrainer, ReplayStats, evaluate
from repro_torch.data.clickstream import ClickStream
from repro_torch.models.recsys import init_recsys
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.sim.cluster import ClusterSpec, Schedule, simulate


@dataclass(frozen=True)
class ModeSetup:
    """One training mode's worker/batch geometry (a row of Tab. 5.1)."""

    mode: str
    num_workers: int
    local_batch: int
    optimizer: str = "adam"
    learning_rate: float = 6e-4
    buffer_size: int = 0       # GBA M; defaults to num_workers
    iota: int = 4
    b1: int = 2                # Hop-BS bound
    b2: int = 8                # BSP aggregation count
    b3: int = 2                # Hop-BW backup count

    @property
    def global_batch(self) -> int:
        m = self.buffer_size or self.num_workers
        if self.mode in ("sync", "hop_bw"):
            return self.local_batch * self.num_workers
        if self.mode == "gba":
            return self.local_batch * m
        if self.mode == "bsp":
            return self.local_batch * self.b2
        return self.local_batch  # async / hop_bs apply per gradient


def default_setups(base_global: int = 4096) -> dict[str, ModeSetup]:
    """Scaled-down analogue of Tab. 5.1: sync 8x512; GBA 16 workers x256
    with M=16 (same global batch); async/hop_bs per-gradient; BSP b2=8
    (mismatched global batch, as in the paper); Hop-BW drops 2/16."""
    return {
        "sync": ModeSetup("sync", 8, base_global // 8),
        # set-A hyper-params (tuned async, Tab. 5.1: Adagrad, higher lr)
        "async": ModeSetup("async", 16, 256, optimizer="adagrad",
                           learning_rate=1e-3),
        # Fig. 2's failure mode: async with the SYNC hyper-parameter set:
        # per-small-batch Adam steps at a large-batch learning rate
        "async_setS": ModeSetup("async", 16, 256),
        "hop_bs": ModeSetup("hop_bs", 16, 256, b1=2),
        # BSP's b2 mismatches the sync global batch, as in Tab. 5.1
        # (800K vs 1.28M on Criteo)
        "bsp": ModeSetup("bsp", 16, 256, b2=max(2, base_global // 512)),
        # paper proportion: b3/N = 100/400 = 25% of gradients discarded
        "hop_bw": ModeSetup("hop_bw", 16, base_global // 16, b3=4),
        "gba": ModeSetup("gba", 16, base_global // 16, buffer_size=16,
                         iota=4),
    }


def schedule_for_day(setup: ModeSetup, spec: ClusterSpec, num_batches: int
                     ) -> Schedule:
    spec = replace(spec, num_workers=setup.num_workers)
    return simulate(spec, setup.mode, num_batches, setup.local_batch,
                    buffer_size=setup.buffer_size or setup.num_workers,
                    iota=setup.iota, b1=setup.b1, b2=setup.b2, b3=setup.b3)


@dataclass
class ContinualResult:
    mode_per_day: list[str]
    auc_per_day: list[float]
    qps_per_day: list[float]
    stats: ReplayStats


def run_continual(params: Any, cfg: RecsysConfig, stream: ClickStream,
                  day_modes: list[str], setups: dict[str, ModeSetup],
                  spec: ClusterSpec, *, batches_per_day: int | None = None,
                  eval_batches: int = 16, start_day: int = 0,
                  seed: int = 0) -> tuple[Any, ContinualResult]:
    """Train day-by-day with per-day training mode; evaluate on day d+1.
    Runs on the device of ``params``."""
    stats = ReplayStats()
    result = ContinualResult([], [], [], stats)
    opt_state = None
    trainer = None
    last_update = None
    current_opt_key = None

    for i, mode in enumerate(day_modes):
        day = start_day + i
        setup = setups[mode]
        nb = batches_per_day or stream.batches_per_day
        # number of raw batches scales with local batch so each mode sees the
        # same number of samples per day
        samples = nb * stream.batch_size
        num_batches = max(setup.num_workers, samples // setup.local_batch)
        sched = schedule_for_day(
            setup, replace(spec, seed=spec.seed + day), num_batches)
        opt_key = (setup.optimizer, setup.learning_rate)
        if trainer is None or opt_key != current_opt_key:
            # switching modes keeps hyper-params unless the experiment
            # explicitly assigns a different set (paper's set A vs set S)
            optimizer = get_optimizer(setup.optimizer, setup.learning_rate)
            trainer = GBATrainer(cfg, optimizer, iota=setup.iota)
            opt_state = optimizer.init(params)
            current_opt_key = opt_key
        day_stream = replace_stream_batch(stream, setup.local_batch)
        params, opt_state, last_update, stats = trainer.replay(
            params, opt_state, sched, day_stream, day,
            last_update=last_update, stats=stats)
        auc = evaluate(params, cfg, stream, day + 1, eval_batches)
        result.mode_per_day.append(mode)
        result.auc_per_day.append(auc)
        result.qps_per_day.append(sched.metrics.qps)
    return params, result


def replace_stream_batch(stream: ClickStream, batch_size: int) -> ClickStream:
    if stream.batch_size == batch_size:
        return stream
    return ClickStream(stream.cfg, stream.seed, stream.zipf_a,
                       stream.num_days, stream.batches_per_day, batch_size,
                       stream.drift)


def pretrain_sync(generator: torch.Generator, cfg: RecsysConfig,
                  stream: ClickStream, setups: dict[str, ModeSetup],
                  spec: ClusterSpec, num_days: int, *,
                  device: str | torch.device = "cuda") -> Any:
    """Train the 'base model' the paper inherits from, in sync mode, from
    fresh parameters drawn from ``generator`` on ``device``."""
    params = init_recsys(cfg, generator=generator, device=device)
    params, _ = run_continual(params, cfg, stream, ["sync"] * num_days,
                              setups, spec)
    return params
