"""Print the records of ``repro_torch.launch.dryrun --all --out FILE`` as a
markdown table: one row an arch, one column an input shape, each cell
the 16 x 16 record, then (after ``‖``) the 2 x 16 x 16 one: device (0,
0)'s argument and temporary bytes (``a``, ``t``, GB of 1e9 B), its
TFLOP (``F``), and its collective bytes (``c``, GB) as all-gather /
all-reduce / reduce-scatter; a record that is not ``ok`` gives its
status.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out d.json
    python scripts/dryrun_table.py d.json

The numbers are a trace on meta tensors on the CPU (``launch.dryrun``),
not a measurement on a device.
"""
from __future__ import annotations

import json
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")
KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def cell(r: dict | None) -> str:
    if r is None:
        return "missing"
    if r["status"] != "ok":
        return r["status"].replace("_", " ")
    m, c = r["memory"], r["collective_bytes"]
    coll = "/".join(f"{c[k] / 1e9:.3g}" for k in KINDS)
    return (f"a {m['argument_bytes'] / 1e9:.3g} t {m['temp_bytes'] / 1e9:.3g}"
            f" F {r['flops'] / 1e12:.3g} c {coll}")


def main(path: str) -> None:
    with open(path) as f:
        got = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    archs = list(dict.fromkeys(a for a, _, _ in got))
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for a in archs:
        cells = [" ‖ ".join(cell(got.get((a, s, m))) for m in MESHES)
                 for s in SHAPES]
        print(f"| {a} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main(sys.argv[1])
