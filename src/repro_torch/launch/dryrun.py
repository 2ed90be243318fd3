"""Dry run of every (architecture x input shape x mesh): one device's placed
step traced on meta tensors, its bytes, flops and collectives recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k [--multi-pod] [--variant serve_tp] [--out f.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out f.json

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each step for 256 (or 512) placeholder CPU devices and reads
XLA's memory and cost analyses.  Here device (0, 0) (``(0, 0, 0)``
across pods) of the production mesh (``launch.mesh.make_production_mesh``)
runs its part of ``launch.steps.build_step``'s step once on meta
tensors: shapes and dtypes alone, nothing allocated on any device
(``flash_decode`` takes its meta branch).  Its world (:class:`MetaWorld`)
opens no process group: it holds one model shard and one data shard and
answers each collective with a meta tensor of the right shape, adding
the output's bytes to a count under the reference's keys.  The train step
runs its applying microstep (every M-th), the costlier branch of the
reference's ``lax.cond``.

Each record keeps the reference's keys where the trace can give them:
``status`` (``ok``, ``skipped`` with the reference's reason, ``failed``
with the error, or ``not_ported`` with ``build_step``'s
``NotImplementedError``), ``flops`` (``torch.utils.flop_counter``: the
matmuls and convolutions of the device's work, the backward's and a
checkpoint's recompute included), ``collective_bytes`` by kind, and
``memory``: ``argument_bytes`` (the held blocks and inputs, exactly),
``output_bytes`` (the step's outputs, each tensor once) and
``temp_bytes`` (the peak bytes live during the step beyond the
arguments, from :class:`LiveBytes`), and for a decode ``cache_bytes``,
the cache's share of the arguments (the long-context decode holds its
data shard's slice of each KV sequence the rules split over ``data``,
and its attention's all-gathers over ``data``, of ``(o, lse)`` or of the
softmax's max and sum and then the outputs, count under
``all-gather``).  ``trace_s`` takes the place of ``lower_s`` and
``compile_s``; there is no ``bytes_accessed`` (XLA's cost
analysis has no counterpart), and the trace counts ``flash_decode``'s
output, not its scratch.  The ``serve_tp`` budget is the card's memory,
``CARD_BYTES``, not the reference's TPU figure.  No ``--device``: it
runs on no device.  It exits 1 on any ``failed`` record.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import arg_bytes, build_step
from repro_torch.launch.variants import VARIANTS

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# torch.cuda.get_device_properties(0).total_memory of an H100 80GB HBM3
# (700 W), the serve_tp budget of one device (read on the card by
# chip_smoke.py's phase 23, which checks it)
CARD_BYTES = 85_017_493_504

SKIP_LONG = ("pure full-attention architecture; 500k decode requires "
             "sub-quadratic/windowed attention (DESIGN.md §4)")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaWorld:
    """Device (0, 0) of a (data, model) mesh, for a trace on meta tensors:
    it holds the first data shard of any count and the first model shard;
    each collective returns a meta tensor of its output's shape and adds
    the output's bytes to ``bytes`` under its kind (nothing where the
    axis has one device)."""

    rank = 0

    def __init__(self, mesh):
        self.size = mesh.shape["data"]
        self.model = mesh.shape["model"]
        self.bytes = {k: 0 for k in COLLECTIVES}

    def _count(self, kind: str, out: torch.Tensor, n: int) -> None:
        if n > 1:
            self.bytes[kind] += _nbytes(out)

    def workers(self, m: int) -> range:
        return range(1)

    def model_shards(self, t: int) -> range:
        return range(1)

    def model_gather(self, parts: list) -> list:
        out = list(parts) + [torch.empty_like(p) for p in parts
                             for _ in range(self.model - 1)]
        for p in parts:
            self._count("all-gather", p.new_empty(
                (self.model, *p.shape)), self.model)
        return out

    def data_gather(self, parts: list, dim: int) -> torch.Tensor:
        shape = list(parts[0].shape)
        shape[dim] *= self.size
        out = parts[0].new_empty(shape)
        self._count("all-gather", out, self.size)
        return out

    def data_reduce(self, whole: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(whole.shape)
        shape[dim] //= self.size
        out = whole.new_empty(shape)
        self._count("reduce-scatter", out, self.size)
        return out

    def data_sum(self, partial: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(partial)
        self._count("all-reduce", out, self.size)
        return out

    def all_losses(self, losses: list) -> list:
        out = [torch.empty_like(x) for x in losses for _ in range(self.size)]
        self._count("all-gather", torch.stack(out), self.size)
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the operators of a region make,
    while they live, and their peak: each new storage an operator returns
    is counted until it is freed (views count once).  ``largest`` is the
    biggest of those storages."""

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.now = self.peak = self.largest = 0

    def _drop(self, n: int) -> None:
        self.now -= n

    def held(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors as already there: an
        operator's view of one adds nothing."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    n = st.nbytes()
                    self._seen[st] = n
                    self.now += n
                    weakref.finalize(st, self._drop, n)
                    self.peak = max(self.peak, self.now)
                    self.largest = max(self.largest, n)
        return out


def trace(fn, args: tuple, world: MetaWorld) -> dict:
    """Run ``fn(*args)`` once on meta tensors: its flops, collective
    bytes, argument, output and peak live bytes beyond the arguments (a
    view of an argument adds nothing), and seconds."""
    t0 = time.time()
    live = LiveBytes()
    live.held(args)
    with FlopCounterMode(display=False) as flops, live:
        out = fn(*args)
    del live._seen
    return {
        "trace_s": round(time.time() - t0, 2),
        "flops": float(flops.get_total_flops()),
        "collective_bytes": dict(world.bytes),
        "memory": {"argument_bytes": arg_bytes(args),
                   "output_bytes": arg_bytes(out),
                   "temp_bytes": live.peak},
    }


def dryrun_step(cfg, shape, mesh, opts: dict | None = None) -> dict:
    """Trace device (0, 0)'s step of ``cfg`` at ``shape`` on ``mesh``
    (``build_step`` with ``opts``; the train step at its applying
    microstep): the record's ``trace_s``, ``flops``, ``collective_bytes``
    and ``memory``.  Raises what ``build_step`` or the step raises."""
    world = MetaWorld(mesh)
    fn, args = build_step(cfg, shape, mesh, world=world,
                          hbm_budget=CARD_BYTES, **(opts or {}))
    if shape.kind == "train":
        state = dict(args[0])
        state["micro"] = fn.gba.buffer_size - 1
        args = (state, *args[1:])
    rec = trace(fn, args, world)
    if shape.kind == "decode":
        rec["memory"]["cache_bytes"] = arg_bytes(args[2])
    return rec


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True, variant: str = "baseline") -> dict:
    """The record of one (arch, shape, production mesh, variant)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "x".join(map(str, mesh.sizes)),
                           "kind": shape.kind, "variant": variant}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = SKIP_LONG
        return rec
    cfg, opts = VARIANTS[variant](cfg, {})
    try:
        rec.update(status="ok", **dryrun_step(cfg, shape, mesh, opts))
        if verbose:
            coll = sum(rec["collective_bytes"].values())
            print(f"[ok] {arch} x {shape_name} x {rec['mesh']} [{variant}]: "
                  f"flops={rec['flops']:.3e} coll={coll:.3e} "
                  f"(trace {rec['trace_s']:.1f}s)", flush=True)
            print(f"     memory: {rec['memory']}", flush=True)
    except NotImplementedError as e:
        rec["status"] = "not_ported"
        rec["reason"] = str(e)
        if verbose:
            print(f"[not ported] {arch} x {shape_name} x {rec['mesh']}: {e}",
                  flush=True)
    except Exception as e:  # a failure here is a bug in the placement
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {rec['mesh']}",
                  flush=True)
            traceback.print_exc()
    return rec


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=tuple(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    def keyof(r):
        return (r["arch"], r["shape"], r["mesh"],
                r.get("variant", "baseline"))

    merged: dict = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            merged = {keyof(r): r for r in json.load(f)}

    def save(rec):
        merged[keyof(rec)] = rec
        if args.out:
            with open(args.out, "w") as f:
                json.dump(list(merged.values()), f, indent=1)

    records = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in INPUT_SHAPES:
                for mp in (False, True):
                    key = (arch, shape_name, "2x16x16" if mp else "16x16",
                           "baseline")
                    prev = merged.get(key)
                    if prev and prev.get("status") in ("ok", "skipped",
                                                       "not_ported"):
                        records.append(prev)   # resume
                        continue
                    rec = dryrun_one(arch, shape_name, mp)
                    records.append(rec)
                    save(rec)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        rec = dryrun_one(args.arch, args.shape, args.multi_pod,
                         variant=args.variant)
        records.append(rec)
        save(rec)
    counts = {s: sum(r["status"] == s for r in records)
              for s in ("ok", "skipped", "not_ported", "failed")}
    print(f"\ndry-run: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['not_ported']} not ported, {counts['failed']} FAILED")
    if counts["failed"]:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
