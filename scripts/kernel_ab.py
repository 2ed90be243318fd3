"""Time the ``flash_decode``, ``embedding_bag_grad_resident`` and
``embedding_bag_grad`` kernels of two checkouts of this repository on one
CUDA card, under one method.

    python3 scripts/kernel_ab.py OTHER

OTHER is the root of another checkout (an earlier commit, say) that holds
``src/repro_torch``.  The script starts one process a turn, in the order
OTHER, this checkout, this checkout, OTHER, so that a drift of the card's
clocks during the call falls on both alike.  Each process builds its
checkout's kernels and times them on the same seeded inputs with the
timing functions of this checkout's ``chip_smoke.py``:

* ``flash_decode`` in bfloat16 at decode_32k, (4, 32768, 8, 4, 128) with
  pos 32,000: 10 calls behind a sleep that holds the card until they are
  queued ("10 held calls", what ``chip_smoke.py`` reads), and 10 calls
  with no sleep ("10 calls, not held"), median of 3 runs each;
* ``flash_decode`` at the serve loop's (4, 160, 8, 4, 128), pos 159: 100
  held calls, median of 3;
* ``embedding_bag_grad_resident``'s launch on sorted ids at (64, 26) ids
  over V = 500 and at (4, 26) over V = 1,000,000, D = 16 both: 20 held
  calls (what ``chip_smoke.py`` reads) and 100 held calls, median of 3;
* ``embedding_bag_grad`` at (a), the replay's presence counts (the 16
  global steps of the quickstart's day 0, (1, 53,248) ids over V =
  1,600,048, D = 0), and at (b), the sparse smoke's backward ((4, 26) ids
  over V = 1,000,000, D = 16): the whole call (the wrapper) and the
  kernel alone, 20 held calls, median of 3.  The kernel alone is the
  launch on sorted ids, except at (a) in a checkout whose wrapper counts
  the raw ids (``embedding_bag_grad_counts``): then it is that launch,
  with no sort.  Each such timing names its launch (``launch``).

A held timing also says whether every sleep outlasted the host's issuing
(``held``, one flag a turn, null where nothing was held); where it did
not, the time includes the host's pace.  The script prints the card's
name and power limit, each process's times, and last one JSON object:
each timing's times by checkout, in turn order.  It needs one card and
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path) -> dict:
    """The timings of ``tree``'s kernels, in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.recsys import CRITEO_DEEPFM
    from repro_torch.core import schedule_for_day
    from repro_torch.data import make_clickstream
    from repro_torch.embeddings import hash_ids
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_grad_resident_sorted, sort_ids)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import quickstart
    src = Path(repro_torch.__file__).resolve()
    if not src.is_relative_to((tree / "src").resolve()):
        raise RuntimeError(f"imported {src}, not {tree}'s repro_torch")
    cycles_per_ms = cs.sleep_cycles_per_ms()
    out = {}
    gen = torch.Generator("cuda").manual_seed(3)
    for b, length, kv, g, hd, pos in cs.FLASH_TIMED:
        q = torch.randn((b, kv, g, hd), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((b, length, kv, hd), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        name = f"flash_decode {(b, length, kv, g, hd)} pos {pos}"
        small = length < 4096
        med, runs, held = cs._timed(
            {"kernel": lambda q=q, k=k, v=v, p=p: flash_decode(q, k, v, p)},
            small, cycles_per_ms)
        out[f"{name}, {100 if small else 10} held calls"] = {
            "ms": med["kernel"], "runs": runs["kernel"],
            "held": held["kernel"]}
        if not small:
            runs = [cs.time_calls(lambda: flash_decode(q, k, v, p), 10)[0]
                    for _ in range(3)]
            out[f"{name}, 10 calls, not held"] = {
                "ms": float(np.median(runs)), "runs": runs, "held": None}
        del q, k, v
        torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(12)
    shapes = {
        "(64, 26) over V=500, D=16": (
            [torch.randint(0, 500, (64, 26), generator=gen, device="cuda",
                           dtype=torch.int32)
             for _ in range(cs.TIMED_ID_SETS)],
            torch.randn((64, 16), generator=gen, device="cuda"), 500),
        "(4, 26) over V=1000000, D=16": (
            [cs.smoke_ids(hash_ids, cpu_gen, cs.SMOKE_BATCH)
             for _ in range(cs.TIMED_ID_SETS)],
            torch.randn((cs.SMOKE_BATCH, cs.SMOKE_D), generator=gen,
                        device="cuda"), cs.SMOKE_V)}
    for label, (id_sets, grad, cap) in shapes.items():
        sorted_sets = [sort_ids(i, cap) for i in id_sets]

        def launch(s, g, cap=cap, f=id_sets[0].shape[1]):
            return embedding_bag_grad_resident_sorted(s[0], s[1], g, cap, f)
        for reps in (cs.SEGMENT_REPS, cs.TIMED_REPS):
            runs = [cs.time_ms(launch, sorted_sets, grad, cycles_per_ms,
                               reps) for _ in range(3)]
            out[f"embedding_bag_grad_resident {label}, {reps} held calls"] = {
                "ms": float(np.median([r[0] for r in runs])),
                "runs": [r[0] for r in runs],
                "held": all(r[2] for r in runs)}
    stream = make_clickstream(CRITEO_DEEPFM, seed=0,
                              batch_size=quickstart.SETUP.local_batch)
    sched = schedule_for_day(quickstart.SETUP, quickstart.SPEC,
                             quickstart.NUM_BATCHES)
    grads = {
        "(a)": ([cs.presence_ids(stream, sched, k)
                 for k in range(len(sched.steps))],
                torch.zeros((1, 0), device="cuda"),
                quickstart.SETUP.buffer_size * CRITEO_DEEPFM.hash_capacity),
        "(b)": shapes["(4, 26) over V=1000000, D=16"]}
    for label, (id_sets, grad, cap) in grads.items():
        fns = {"whole call": (
            lambda i, g, cap=cap: eb.embedding_bag_grad(i, g, cap), id_sets,
            "the wrapper")}
        if grad.shape[1] == 0 and hasattr(eb, "embedding_bag_grad_counts"):
            fns["kernel"] = (
                lambda i, g, cap=cap: eb.embedding_bag_grad_counts(i, cap),
                id_sets, "embedding_bag_grad_counts on the raw ids")
        else:
            fns["kernel"] = (
                lambda s, g, cap=cap, f=id_sets[0].shape[1]:
                eb.embedding_bag_grad_sorted(s[0], s[1], g, cap, f),
                [sort_ids(i, cap) for i in id_sets],
                "embedding_bag_grad_sorted on sorted ids")
        for what, (fn, sets, launch) in fns.items():
            runs = [cs.time_ms(fn, sets, grad, cycles_per_ms,
                               cs.SEGMENT_REPS) for _ in range(3)]
            out[f"embedding_bag_grad {label} {what}, "
                f"{cs.SEGMENT_REPS} held calls"] = {
                "ms": float(np.median([r[0] for r in runs])),
                "runs": [r[0] for r in runs],
                "held": all(r[2] for r in runs), "launch": launch}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", type=Path,
                    help="root of the checkout to compare with this one")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if args.measure is not None:
        print(json.dumps(measure(args.measure)))
        return 0
    if args.other is None:
        ap.error("OTHER is required")
    other = args.other.resolve()
    if not (other / "src" / "repro_torch").is_dir():
        ap.error(f"{other} holds no src/repro_torch")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    summary: dict = {}
    for who, tree in turns:
        run = subprocess.run([sys.executable, __file__, "--measure",
                              str(tree)], capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            print(f"kernel_ab: timing {tree} failed", file=sys.stderr)
            return 1
        times = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{who} ({tree}): {json.dumps(times)}")
        for key, t in times.items():
            row = summary.setdefault(key, {"other": [], "this": [],
                                           "held": []})
            row[who].append(t["ms"])
            row["held"].append(t["held"])
    print(json.dumps({"other": str(other), "this": str(ROOT),
                      "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
