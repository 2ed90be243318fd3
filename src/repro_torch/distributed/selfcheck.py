"""Hold the process-group backend of the worker-parallel steps to the
in-process one.

:func:`compare` runs :func:`run` first on R ranks (``process_group.spawn``:
gloo on the CPU, NCCL one rank per card on ``cuda``), then with every
worker in this process (``inprocess``, one intra-op thread, as a gloo rank
runs), and counts the elements whose bits differ.  Each process saves what
it holds: its run of a flat vector that is split over the ranks (``RUNS``,
concatenated in rank order before the comparison), and everything else,
which every rank holds whole (compared rank by rank).  :func:`run` is the
ranks' entry function, here because a spawned process cannot import a
test module.  Its cases:

* ``none``, ``int8``, ``onebit``: the wire step
  (``repro_torch.core.gba_shard_map``), ``STEPS`` global steps with
  ``WARMUP`` float32 warmup step: its run of the params and the
  accumulator, its wire rows and the losses;
* ``psum``: the pytree all-reduce step (Adagrad), ``STEPS`` global steps:
  the replicated params and accumulator and the losses;
* ``switched``: ``SwitchDriver.run_schedule`` with ``sync_impl="psum"``
  over an 8-step schedule, sync x3, gba x3, sync x2, whose step 5 holds an
  Eq. (1)-dropped slot and a tombstone: the final flat state, the losses
  and the ``SwitchResult``;
* ``fused``: the sharded fused step (``launch.programs``), each
  microstep's batch split over the ranks, ``FUSED_STEPS`` microsteps of M
  = ``FUSED_M``: the gathered params, the run of the accumulator, the
  ``gba_apply`` launches per held shard and global step, and the losses.
  A loss is the sum of the ranks' shares of the batch's mean, rounded
  other than the mean of the whole batch, so ``compare`` gives its
  largest relative difference instead of a count (``ROUNDED``);
* ``fsdp``: the same step with the params placed over ``data`` by the
  rule tables (``place_state=True``, ``distributed.fsdp``) on
  ``FSDP_SHAPES``, whose embedding, head and MLP rows split over the 4
  data shards: the params gathered whole, the run of the accumulator,
  the launches and the losses as ``fused``, and on each process the
  elements whose bits differ from the same step with
  ``place_state=False`` on the same world (``vs_unplaced``) and the
  bytes it holds less the rules' share of its blocks (``bytes``), both
  0.

The exact problem makes every gradient exact, so the comparison does not
hang on the order of a library's sums: leaves that are not tile
multiples in 3 layer groups, tile 256; the loss is ``mean(x) * sum of
squares`` with ``x`` in multiples of 1/8 and the squares folded in
halves, element by element; worker 2 is three steps stale, which Eq. (1)
drops at iota 2.  The fused step sums the ranks' shares of one gradient,
so its loss is linear in the params instead (``linear_loss``: each
element's gradient is ``mean(x)`` times a small integer), exact however
the batch is split and summed.

The demo cases run the switching harness's demo MLP, whose matmuls round
by thread count, so the in-process side runs one thread as each rank does:

* ``demo_auto``: ``SwitchDriver.run(mode="auto")`` on the strained plan,
  ``DEMO_BATCHES`` batches of 256: the final flat state, the losses and
  the ``SwitchResult``;
* ``demo_schedule``: the 8-step schedule with ``sync_impl="psum"``;
* ``demo_nan``: one global step whose last worker's batch is all NaN, in
  psum sync, fused sync, async and compressed async mode: what it
  committed (elements of the flat state whose bits moved, and, after the
  compressed step, the warmup count and the nonzero residual elements
  left), which must be 0 on every rank.

:func:`run_lm_psum` is the ranks' entry for the LM's sync psum step on
given params and batches, which the tests hold to the reference's psum
step.  :func:`run_model_axis` is the ranks' entry for the fused step over
a (W, T) mesh on an (Rd, Rm) grid: it runs the step with the model shards
spread over the model subgroup, then with every model shard in process
over the same data subgroup, and saves both, which must agree bit for
bit; with ``place_state`` both hold the params over ``data`` (FSDP), and
a third run, ``place_state=False`` on the ranks, must agree with them
too.  :func:`run_steps` does the same for ``launch.steps.build_step``'s
placed prefill, decode and train steps over a (2, 2) mesh, and holds the
batch-1 decode whose KV sequence the rules split over ``data`` on the
ranks to the same decode with every shard in process (``inprocess``).
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import GBAConfig
from repro_torch.core.compression import SCHEMES, CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.gba_shard_map import (make_gba_fused_psum_step,
                                            make_gba_psum_step)
from repro_torch.distributed import fsdp, inprocess, process_group
from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops
from repro_torch.kernels.ref import EPS
from repro_torch.launch import switch_driver as SD
from repro_torch.launch.programs import (init_fsdp_state,
                                         init_fused_train_state,
                                         make_fsdp_step,
                                         make_fused_train_step)
from repro_torch.optim import adagrad, tree_map
from repro_torch.sim.cluster import ClusterSpec
from repro_torch.sim.faults import FaultPlan

TILE, IOTA, LR, STEPS, WARMUP = 256, 2, 0.05, 3, 1
ROWS_PER_WORKER = 8
FUSED_M, FUSED_STEPS = 2, 6
DEMO_BATCHES = 96
SHAPES = {"embed": (33, 9), "blocks": {"l0": {"w": (41,), "b": (7, 5)}},
          "head": (700,)}
# the fsdp case's tree: the names the rule tables split over data (the
# embedding's and the MLP's d_model, the head's rows), 16 a multiple of 4
FSDP_SHAPES = {"embed": (33, 16), "lm_head": (16, 40),
               "final_norm": {"scale": (16,)},
               "blocks": {"l0": {"mlp": {"wi_up": (2, 16, 24),
                                         "wo": (2, 24, 16)},
                                 "ln1": {"scale": (2, 16)}}}}
# its re-layouts' window: several to a layer group
FSDP_WINDOW = 300
CASES = SCHEMES + ("psum", "switched", "fused", "fsdp", "demo_auto",
                   "demo_schedule", "demo_nan")
# the flat vectors each process holds a run of
RUNS = ("param", "accum", "residual", "momentum")
# (case, name) compared by relative difference, not bits
ROUNDED = {("fused", "loss"), ("fsdp", "loss")}
SWITCHED = ["sync"] * 3 + ["gba"] * 3 + ["sync"] * 2


def problem(workers: int, seed: int = 7) -> tuple[dict, torch.Tensor]:
    """The params (float32 normal draws of ``SHAPES``) and the ``(STEPS,
    ROWS_PER_WORKER * workers)`` inputs, on the CPU."""
    rng = np.random.default_rng(seed)
    params = _draw(rng, SHAPES)
    return params, _inputs(rng, (STEPS, ROWS_PER_WORKER * workers))


def _draw(rng: np.random.Generator, shape) -> dict:
    """Float32 normal draws of a tree of shapes."""
    if isinstance(shape, dict):
        return {k: _draw(rng, v) for k, v in shape.items()}
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _inputs(rng: np.random.Generator, shape: tuple) -> torch.Tensor:
    """``x`` in multiples of 1/8, nonzero, within [-2, 2]."""
    x = rng.integers(1, 17, shape) * rng.choice([-1.0, 1.0], shape) / 8
    return torch.from_numpy(x.astype(np.float32))


def _fold(v: torch.Tensor) -> torch.Tensor:
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = torch.cat([v, v.new_zeros(n - v.shape[0])])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def loss_fn(params, batch: dict) -> torch.Tensor:
    s = None
    for _, leaf in tree_paths(params):
        f = leaf.float().reshape(-1)
        s = _fold(f * f) if s is None else s + _fold(f * f)
    return batch["x"].mean() * s


def linear_loss(params, batch: dict) -> torch.Tensor:
    """``mean(x) * sum(leaf * u)``, ``u`` the integers ±1 ... ±5 by
    element: the gradient ``mean(x) * u`` is exact, and so is any sum of
    the gradients of a split of the batch."""
    s = None
    for _, leaf in tree_paths(params):
        f = leaf.float().reshape(-1)
        i = torch.arange(f.shape[0], device=f.device)
        t = _fold(f * ((i % 5 + 1) * (1 - 2 * (i // 5 % 2))))
        s = t if s is None else s + t
    return batch["x"].mean() * s


def tokens(step: int, workers: int) -> list[int]:
    """Every worker's token at global step ``step``: the step, worker 2's
    three steps old."""
    return [step - 3 if w == 2 else step for w in range(workers)]


def schedule(workers: int, iota: int) -> list:
    """The 8-step swap schedule: every slot its own batch and a fresh
    token, but at step 5 slot 1 holds token 0 (dropped by Eq. (1)) and
    slot 2 a tombstone."""
    steps, b = [], 0
    for k in range(8):
        toks, bats = [k] * workers, list(range(b, b + workers))
        b += workers
        if k == 5:
            toks[1], toks[2], bats[2] = 0, k - iota - 1, -1
        steps.append(SD.GlobalStep(tuple(toks), tuple(bats)))
    return steps


def _rows(world, workers: int, x: torch.Tensor) -> torch.Tensor:
    """The rows of the workers held here of a ``(ROWS_PER_WORKER *
    workers,)`` batch."""
    mine = world.workers(workers)
    return x[mine[0] * ROWS_PER_WORKER:(mine[-1] + 1) * ROWS_PER_WORKER]


def _flat(tree) -> torch.Tensor:
    return torch.cat([x.float().reshape(-1).cpu()
                      for _, x in tree_paths(tree)])


def _wire(world, device, workers, scheme, params, xs) -> dict:
    layout = ShardedFlatLayout.from_params(params, workers, tile=TILE,
                                           group_by=lambda path: path[0])
    mine = world.workers(workers)
    ss = layout.shard_size
    pol = CompressionPolicy(scheme=scheme, warmup_steps=WARMUP)
    warm, comp = (make_gba_fused_psum_step(
        workers, loss_fn, layout, iota=IOTA, lr=LR, compress=pol, warm=w,
        world=world) for w in (True, False))
    pf = layout.ravel(params)[mine[0] * ss:(mine[-1] + 1) * ss].to(
        device, copy=True)
    af = torch.full_like(pf, 0.1)
    wire = (pol.init_wire_state(layout, len(mine), device)
            if pol.stateful else None)
    losses = []
    for t in range(STEPS):
        batch = {"x": _rows(world, workers, xs[t]).to(device)}
        toks = torch.tensor(tokens(t, workers), dtype=torch.int32,
                            device=device)
        step = warm if t < WARMUP else comp
        if wire is None:
            pf, af, loss = step(pf, af, batch, toks, t)
        else:
            pf, af, loss, wire = step(pf, af, batch, toks, t, wire)
        losses.append(loss)
    return {"param": pf.cpu(), "accum": af.cpu(),
            "loss": torch.stack(losses).cpu(),
            **{k: v.cpu() for k, v in (wire or {}).items()}}


def _psum(world, device, workers, params, xs) -> dict:
    opt = adagrad(LR, eps=EPS, initial_accum=0.1)
    step = make_gba_psum_step(workers, loss_fn, opt, IOTA, world=world)
    p = _to(params, device)
    state, losses = opt.init(p), []
    for t in range(STEPS):
        batch = {"x": _rows(world, workers, xs[t]).to(device)}
        toks = torch.tensor(tokens(t, workers), dtype=torch.int32,
                            device=device)
        p, state, loss = step(p, state, batch, toks, t)
        losses.append(loss)
    return {"params": _flat(p), "opt": _flat(state["accum"]),
            "loss": torch.stack(losses).cpu()}


def _result(res) -> dict:
    return {"param_flat": torch.from_numpy(res.param_flat),
            "accum_flat": torch.from_numpy(res.accum_flat),
            "loss": torch.tensor(res.losses, dtype=torch.float64),
            "result": json.dumps(res.to_json(), sort_keys=True)}


def _switched(world, device, workers, params, seed: int = 11) -> dict:
    xs = _inputs(np.random.default_rng(seed), (8 * workers, ROWS_PER_WORKER))
    drv = SD.SwitchDriver(
        workers, loss_fn, _to(params, device), spec=ClusterSpec(workers),
        plan=FaultPlan.quiet(workers),
        cfg=SD.SwitchConfig(local_batch=ROWS_PER_WORKER, iota=IOTA, lr=LR,
                            sync_impl="psum"),
        batch_fn=lambda i: {"x": xs[i].numpy()},
        group_by=lambda path: path[0], tile=TILE, world=world)
    return _result(drv.run_schedule(schedule(workers, IOTA), SWITCHED))


def _fused(world, device, workers, params, seed: int = 13,
           place_state: bool = False) -> dict:
    xs = _inputs(np.random.default_rng(seed),
                 (FUSED_STEPS, ROWS_PER_WORKER * workers))
    gba = GBAConfig(local_batch=ROWS_PER_WORKER * workers,
                    buffer_size=FUSED_M, staleness_tolerance=IOTA)
    if place_state:
        placement, state = init_fsdp_state(_to(params, device), gba,
                                           workers, tile=TILE, world=world)
        step = make_fsdp_step(None, gba, placement, lr=LR, world=world,
                              loss_fn=linear_loss)
    else:
        layout, state = init_fused_train_state(
            _to(params, device), gba, workers, tile=TILE, world=world)
        step = make_fused_train_step(None, gba, layout, lr=LR,
                                     world=world, loss_fn=linear_loss)
    rows = xs.shape[1] // world.size
    rank = world.workers(workers)[0] // len(world.workers(workers))
    losses, launches = [], []
    for i in range(FUSED_STEPS):
        # microstep 5's token is 4 steps old at its apply: dropped
        token = -2 if i == 5 else i // FUSED_M
        calls = ops.kernel_calls["gba_apply_flat"]
        state, loss = step(state, {"x": xs[i, rank * rows:(rank + 1)
                                           * rows].to(device)}, token)
        losses.append(loss)
        if (i + 1) % FUSED_M == 0:
            launches.append((ops.kernel_calls["gba_apply_flat"] - calls)
                            / len(world.workers(workers)))
    out = {"accum": state["accum"].cpu(), "loss": torch.stack(losses).cpu(),
           "launches_per_shard": torch.tensor(launches)}
    if not place_state:
        return {"params": _flat(state["params"]), **out}
    share = S.block_bytes(params, placement.specs, placement.mesh)
    return {"params": _flat(fsdp.gather(placement, state["params"])[0]),
            **out, "bytes": torch.tensor(
                [fsdp.held_bytes(state["params"])
                 - share * len(placement.held)])}


def _fsdp(world, device, workers) -> dict:
    """The fused step with the params over ``data`` against
    ``place_state=False`` on the same world and problem, its re-layouts
    in windows of ``FSDP_WINDOW`` elements."""
    params = _draw(np.random.default_rng(17), FSDP_SHAPES)
    window, fsdp.WINDOW = fsdp.WINDOW, FSDP_WINDOW
    try:
        got = _fused(world, device, workers, params, place_state=True)
    finally:
        fsdp.WINDOW = window
    want = _fused(world, device, workers, params)
    got["vs_unplaced"] = torch.tensor([
        differing(got[k], want[k]) for k in ("params", "accum", "loss")])
    return got


def _demo_driver(world, device, workers, impl: str, *, local_batch=8,
                 plan=None, spec=None, compress=None):
    params, demo_loss, group_by = SD.demo_model(device=device)
    return SD.SwitchDriver(
        workers, demo_loss, params, spec=spec or ClusterSpec(workers),
        plan=plan or FaultPlan.quiet(workers),
        cfg=SD.SwitchConfig(local_batch=local_batch, sync_impl=impl),
        batch_fn=SD.demo_batch_fn(local_batch), group_by=group_by,
        compress=compress, world=world)


def _demo_nan(world, device, workers) -> dict:
    out = {}
    nan = {k: np.full_like(v, np.nan)
           for k, v in SD.demo_batch_fn(8)(0).items()}
    int8 = CompressionPolicy(scheme="int8", warmup_steps=1)
    for name, mode, impl, comp in (("psum_sync", "sync", "psum", None),
                                   ("fused_sync", "sync", "fused", None),
                                   ("async", "gba", "fused", None),
                                   ("int8_async", "gba", "fused", int8)):
        drv = _demo_driver(world, device, workers, impl, compress=comp)
        st = drv._fresh_state(mode)
        zeros = np.zeros(workers, np.int64)
        if comp is not None:            # past the warmup
            drv._exec(st, zeros, [drv.batch_fn(i) for i in range(workers)])
        before = drv._canonical_flat(st)
        loss = drv._exec(st, zeros, [drv.batch_fn(i)
                                     for i in range(workers - 1)] + [nan])
        moved = sum(int((a.view(np.int32) != b.view(np.int32)).sum())
                    for a, b in zip(before, drv._canonical_flat(st)))
        left = 0 if comp is None else st.warm_count + int(
            st.wire["residual"].count_nonzero())
        out[name] = torch.tensor([moved + left + int(not np.isnan(loss))])
    return out


def run(world, device: torch.device, workers: int, cases: tuple,
        out_dir: str) -> None:
    """Run every case of ``cases`` over ``world`` on ``device`` and save
    what this process holds, on the CPU, to ``out_dir/part<first
    worker>.pt``: ``{case: {name: tensor or str}}``."""
    params, xs = problem(workers)
    mine = world.workers(workers)
    held = {}
    for case in cases:
        if case in SCHEMES:
            held[case] = _wire(world, device, workers, case, params, xs)
        elif case == "psum":
            held[case] = _psum(world, device, workers, params, xs)
        elif case == "switched":
            held[case] = _switched(world, device, workers, params)
        elif case == "fused":
            held[case] = _fused(world, device, workers, params)
        elif case == "fsdp":
            held[case] = _fsdp(world, device, workers)
        elif case == "demo_auto":
            held[case] = _result(_demo_driver(
                world, device, workers, "psum", local_batch=256,
                plan=SD.demo_plan("strained", workers),
                spec=SD.demo_spec(workers)).run(DEMO_BATCHES, mode="auto"))
        elif case == "demo_schedule":
            held[case] = _result(_demo_driver(
                world, device, workers, "psum").run_schedule(
                    schedule(workers, 4), SWITCHED))
        elif case == "demo_nan":
            held[case] = _demo_nan(world, device, workers)
        else:
            raise ValueError(f"unknown case {case!r}: expected one of "
                             f"{CASES}")
    torch.save(held, os.path.join(out_dir, f"part{mine[0]}.pt"))


def run_lm_psum(world, device: torch.device, cfg, inp: dict, gba: GBAConfig,
                lr: float, out_dir: str) -> None:
    """The LM's sync psum step (``build_programs(mode="sync_psum")``) of
    ``cfg`` over ``world``, from the numpy params and batches of ``inp``
    (``p/<path>`` leaves; per step ``i`` the whole ``tokens{i}`` and
    ``labels{i}``, of which this rank takes its workers' rows, the
    workers' tokens ``toks{i}`` and the global step ``gstep{i}``), saving
    to ``out_dir/rank<r>.npz`` the final params (``p/<path>``), the
    accumulator (``a/<path>``) and every ``loss{i}``."""
    from repro_torch.launch.programs import build_programs
    params = {}
    for key, v in inp.items():
        if key.startswith("p/"):
            node = params
            *head, last = key[2:].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(np.array(v)).to(device)
    m = gba.buffer_size
    mine, b = world.workers(m), gba.local_batch
    progs = build_programs(cfg, gba, params=params, mode="sync_psum", lr=lr,
                           workers=m, world=world)
    params, opt, out = progs.state["params"], progs.state["opt"], {}
    for i in range(int(inp["steps"])):
        batch = {k: torch.from_numpy(inp[f"{k}{i}"][mine[0] * b:
                                                    (mine[-1] + 1) * b])
                 .to(device) for k in ("tokens", "labels")}
        params, opt, loss = progs.step(
            params, opt, batch, torch.from_numpy(inp[f"toks{i}"]).to(device),
            int(inp[f"gstep{i}"]))
        out[f"loss{i}"] = loss.cpu().numpy()
    for prefix, tree in (("p/", params), ("a/", opt["accum"])):
        for path, leaf in tree_paths(tree):
            out[prefix + "/".join(path)] = leaf.cpu().numpy()
    np.savez(os.path.join(out_dir, f"rank{mine[0] // len(mine)}.npz"), **out)


def run_model_axis(world, device: torch.device, gba: GBAConfig,
                   cases: list, tokens: list, workers: int, model: int,
                   out: str, place_state: bool = False,
                   window: int | None = None) -> None:
    """The fused step over the (``workers``, ``model``) mesh for each of
    ``cases``, ``(cfg, params, batches)``: from ``params`` (whole, on the
    host) over ``batches`` (whole microsteps, as numpy) with ``tokens``,
    once over ``world`` (this rank's model shards, its data rows), once
    over ``world.without_model()`` (every model shard here, the same
    rows), the params held over ``data`` where ``place_state`` (then
    once more over ``world`` with ``place_state=False``, ``unplaced``);
    saves each case's runs' losses, and each held model shard's params
    (gathered whole over ``data`` and raveled) and accumulator blocks, and
    under FSDP the bytes the run's blocks hold less the rules' share of
    them, to ``out/rank{r}.pt``, a list in the order of ``cases``.
    ``window``, where given, is this process's ``fsdp.WINDOW`` for the
    runs."""
    saved = fsdp.WINDOW
    if window is not None:
        fsdp.WINDOW = window
    try:
        runs = _model_axis_runs(world, device, gba, cases, tokens,
                                workers, model, place_state)
    finally:
        fsdp.WINDOW = saved
    rank = world.rank * world.model_size + world.model_rank
    torch.save(runs, os.path.join(out, f"rank{rank}.pt"))


def _model_axis_runs(world, device, gba, cases, tokens, workers, model,
                     place_state) -> list:
    from repro_torch.launch.programs import build_programs
    runs = []
    labels = [("ranks", world, place_state),
              ("process", world.without_model(), place_state)]
    if place_state:
        labels.append(("unplaced", world, False))
    for cfg, params, batches in cases:
        saved = {}
        for label, w, placed in labels:
            progs = build_programs(cfg, gba, params=_to(params, device),
                                   mode="fused", lr=1e-3, workers=workers,
                                   world=w, model=model, place_state=placed)
            rows = gba.local_batch // w.size
            state, losses = progs.state, []
            for b, token in zip(batches, tokens):
                state, loss = progs.step(state, {
                    k: torch.from_numpy(v[w.rank * rows:(w.rank + 1) * rows])
                    .to(device) for k, v in b.items()}, token)
                losses.append(loss)
            lay = progs.layout
            held = (progs.model_axis.held if progs.model_axis is not None
                    else range(1))
            trees = progs.gather_params(state["params"])
            trees = trees if progs.model_axis is not None else [trees]
            run = state["accum"].shape[0] // len(held)
            saved[label] = {
                "losses": torch.stack(losses).cpu(),
                **{f"param/{t}": lay.ravel(s).cpu()
                   for t, s in zip(held, trees)},
                **{f"accum/{t}": state["accum"][i * run:(i + 1) * run].cpu()
                   for i, t in enumerate(held)}}
            if placed:
                p = progs.placement
                share = S.block_bytes(params, p.specs, p.mesh)
                saved[label]["bytes"] = torch.tensor(
                    [fsdp.held_bytes(state["params"])
                     - share * len(held) * len(p.held)])
        runs.append(saved)
    return runs


def run_steps(world, device: torch.device, cfg, params: dict, out: str
              ) -> None:
    """``launch.steps.build_step``'s prefill, decode and train steps of
    ``cfg`` over a (data 2, model 2) mesh from the whole ``params`` (on
    the host), once over ``world`` (this rank's model shards and data
    rows) and once over ``world.without_model()`` (both model shards here,
    the same rows): the prefill of 4 prompts of 16 tokens, 2 decode steps
    from a cache of 24 positions, and 2 train microsteps at M = 2 (the
    second applies).  Saves, for each run and this rank's model shards,
    the logits, next tokens and losses, every cache slice, and the
    params, accumulator and optimizer blocks, to ``out/rank{r}.pt``.

    Then ``long``: the decode of one sequence of ``gemma3-12b``'s
    ``.reduced()`` (local rings and a global layer, drawn from seed 11 in
    ``cfg``'s dtype) from a prompt of 11 tokens in a cache of 24
    positions, whose sequence the rules split over the 2 data shards
    (slices of 12: the second step writes the second slice), 2 steps,
    once over ``world`` and once with every shard in process
    (``inprocess``); saved under ``"long"`` of each run, the cache slices
    that this rank holds keyed by model and data shard."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    mesh = Mesh(("data", "model"), (2, 2))
    mine = world.model_shards(2)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
    gba = GBAConfig(local_batch=4, buffer_size=2)
    runs = {}
    for label, w in (("ranks", world), ("process", world.without_model())):
        def held(trees, held_idx, name):
            return {f"{name}/{t}/{'/'.join(p)}": x.detach().cpu()
                    for t, tree in zip(held_idx, trees) if t in mine
                    for p, x in tree_paths(tree)}
        res = {}
        pre, _ = steps.build_step(cfg, InputShape("p", 16, 4, "prefill"),
                                  mesh, world=w)
        logits, caches = pre(pre.place_params(_to(params, device)),
                             pre.place_batch({"tokens": toks.to(device)}))
        res["prefill"] = {"logits": logits.cpu(),
                          **held(caches, pre.tp.held, "cache")}
        dec, _ = steps.build_step(cfg, InputShape("d", 24, 4, "decode"),
                                  mesh, world=w)
        whole = _to(params, device)
        _, cache = T.prefill(whole, cfg, toks.to(device), cache_len=24)
        caches, tok = dec.place_cache(cache), dec.place_batch(
            {"t": toks[:, -1:].to(device)})["t"]
        res["decode"] = {}
        ps = dec.place_params(whole)
        for i in range(2):
            tok, logits, caches = dec(ps, tok, caches)
            res["decode"][f"logits{i}"] = logits.cpu()
            res["decode"][f"next{i}"] = tok.cpu()
        res["decode"].update(held(caches, dec.tp.held, "cache"))
        tr, _ = steps.build_step(cfg, InputShape("t", 16, 4, "train"), mesh,
                                 gba, world=w)
        state = tr.init_state(_to(params, device))
        batch = tr.place_batch({"tokens": toks.to(device),
                                "labels": labels.to(device)})
        res["train"] = {}
        for i in range(2):
            state, loss = tr(state, batch, 0)
            res["train"][f"loss{i}"] = loss.reshape(1).cpu()
        for name, blocks in (("params", state["params"]),
                             ("acc", state["acc"]),
                             ("m", state["opt"]["m"]),
                             ("v", state["opt"]["v"])):
            res["train"].update(held([b[0] for b in blocks], tr.tp.held,
                                     name))
        res["long"] = _long_decode(world if label == "ranks" else inprocess,
                                   world, cfg.dtype, device)
        runs[label] = res
    rank = world.rank * world.model_size + world.model_rank
    torch.save(runs, os.path.join(out, f"rank{rank}.pt"))


def _long_decode(w, world, dtype: str, device: torch.device) -> dict:
    """:func:`run_steps`'s ``long`` decode over ``w``: logits and next
    tokens of each step, and the slices of every cache leaf that
    ``world``'s rank holds, keyed ``cache/{model}/{data}/{path}`` (a leaf
    whole over ``data`` under data shard ``-``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(),
                              dtype=dtype)
    params = _to(T.init_model(cfg, generator=torch.Generator().manual_seed(
        11), device="cpu"), device)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 11))).to(device)
    dec, _ = steps.build_step(cfg, InputShape("l", 24, 1, "decode"),
                              Mesh(("data", "model"), (2, 2)), world=w)
    _, cache = T.prefill(params, cfg, toks, cache_len=24)
    caches, tok = dec.place_cache(cache), toks[:, -1:].to(torch.int32)
    held = dec.place_params(params)
    res = {}
    for i in range(2):
        tok, logits, caches = dec(held, tok, caches)
        res[f"logits{i}"], res[f"next{i}"] = logits.cpu(), tok.cpu()
    mine, data = world.model_shards(2), world.workers(2)
    for t, tree in zip(dec.tp.held, caches):
        for path, x in tree_paths(tree):
            sliced = path[-1].startswith("#")
            name = "/".join(path[:-1] if sliced else path)
            shard = (dec.tp.seq_shards()[int(path[-1][1:])] if sliced
                     else "-")
            if t in mine and (shard == "-" or shard in data):
                res[f"cache/{t}/{shard}/{name}"] = x.detach().cpu()
    return res


def _to(params: dict, device: torch.device) -> dict:
    return tree_map(lambda t: t.to(device, copy=True), params)


def differing(got, want) -> int:
    """The elements of ``got`` whose bits differ from ``want``'s (all of
    them where the shapes or dtypes differ); 1 or 0 for strings."""
    if isinstance(want, str):
        return int(got != want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return want.numel()
    return int((got.view(torch.uint8).view(got.shape + (-1,)) !=
                want.view(torch.uint8).view(want.shape + (-1,)))
               .any(-1).sum())


def compare(ranks: int, workers: int = 4, cases: tuple = CASES,
            device: str = "cuda", timeout: float = 600.0,
            held: dict | None = None) -> dict:
    """``{case: {name: elements whose bits differ}}`` between :func:`run`
    on ``ranks`` ranks and in process, for each name a case saves: a run
    of the ranks' (``RUNS``) against the in-process vector, everything
    else each rank's against the in-process value (the most any rank
    differs by); for the names of ``ROUNDED``, the largest relative
    difference instead.  ``held``, if given, receives what the in-process
    run saved."""
    dev = process_group.check_world(ranks, workers, device)
    with tempfile.TemporaryDirectory() as tmp:
        dist_dir, local_dir = (os.path.join(tmp, d) for d in ("dist", "in"))
        os.mkdir(dist_dir)
        os.mkdir(local_dir)
        process_group.spawn(run, ranks, workers, tuple(cases), dist_dir,
                            device=dev.type, timeout=timeout)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            run(inprocess, dev, workers, tuple(cases), local_dir)
        finally:
            torch.set_num_threads(threads)
        k = workers // ranks
        parts = [torch.load(os.path.join(dist_dir, f"part{r * k}.pt"))
                 for r in range(ranks)]
        want = torch.load(os.path.join(local_dir, "part0.pt"))
    if held is not None:
        held.update(want)
    report = {}
    for case, ref in want.items():
        report[case] = {}
        for name, v in ref.items():
            got = ([torch.cat([p[case][name] for p in parts])]
                   if name in RUNS else [p[case][name] for p in parts])
            report[case][name] = max(
                float(((g - v).abs() / v.abs()).max())
                if (case, name) in ROUNDED else differing(g, v) for g in got)
    return report
