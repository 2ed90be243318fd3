"""Reckon each device's bytes for the sharded fused step over a (data W,
model T) mesh, with the weights held over ``data`` (FSDP,
``place_state=True``) and without (``place_state=False``), from the rule
tables alone: arithmetic on meta tensors, no device and no allocation.

    PYTHONPATH=src python scripts/fsdp_bytes.py [--mesh 2x2] [--buffer 4]
        [--arch granite-8b:36 ...]

``--arch A:L`` takes arch A at L layers (its full depth without ``:L``).
Per device, in GB of 1e9 B:

* ``flat``: the float32 accumulator and the M-slot buffer, (M + 1) x 4 B
  over the device's columns of its model shard's ``ShardedFlatLayout``;
* ``weights``: the weights the device keeps between microsteps (FSDP: its
  (data, model) block, the rules' share; else its model shard whole);
* ``grad``: the gradient it holds at the push (FSDP: the float32 rows of
  its block; else the model shard's gradient tree in the weights' dtype
  and its float32 ravel);
* ``gather``: the largest forward gather (FSDP: a top-level module or one
  repeat of ``blocks``, whole over ``data``; else 0) and ``relayout``,
  the bound on a re-layout's float32 transient (``fsdp.transient_bytes``
  at the default ``fsdp.WINDOW``; the largest layer group's extent,
  ``peak_gather``, is printed beside it);
* ``total``: their sum, before any activation.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import get_config
from repro_torch.core.flat_sharded import TILE, ShardedFlatLayout
from repro_torch.distributed import fsdp, inprocess
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T

DEFAULT = ("granite-8b:36", "gemma2-27b", "phi3.5-moe-42b-a6.6b",
           "llama-3.2-vision-11b", "kimi-k2-1t-a32b")


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in T._leaves(tree))


def reckon(arch: str, layers: int | None, w: int, t: int, m: int) -> dict:
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shapes = T.param_shapes(cfg)
    mesh = Mesh(("data", "model"), (w, t))
    specs = S.param_specs(shapes, mesh)
    shard = S.place(shapes, specs, mesh, 0)
    layout = ShardedFlatLayout.from_params(shard, w, TILE,
                                           group_by=T.param_group_key)
    pl = fsdp.Placement.of(layout, specs, mesh, inprocess)
    block = S.block_bytes(shapes, specs, mesh)
    whole_shard = _bytes(shard)
    flat = (m + 1) * 4 * layout.shard_size
    fs = {"weights": block, "grad": 2 * block,
          "gather": fsdp.largest_gather(pl)[1],
          "relayout": fsdp.transient_bytes(pl)}
    un = {"weights": whole_shard,
          "grad": whole_shard + 4 * layout.padded_total,
          "gather": 0, "relayout": 0}
    out = {"arch": arch, "layers": cfg.num_layers,
           "params": sum(x.numel() for x in T._leaves(shapes)),
           "mesh": f"{w}x{t}", "M": m, "flat": flat,
           "columns": layout.shard_size,
           "peak_gather": layout.peak_gather_bytes}
    for name, part in (("fsdp", fs), ("unplaced", un)):
        out[name] = {**part, "total": flat + sum(part.values())}
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--buffer", type=int, default=4)
    ap.add_argument("--arch", action="append")
    args = ap.parse_args(argv)
    w, t = (int(x) for x in args.mesh.split("x"))
    rows = []
    for spec in args.arch or DEFAULT:
        arch, _, layers = spec.partition(":")
        r = reckon(arch, int(layers) if layers else None, w, t,
                   args.buffer)
        rows.append(r)
        gb = lambda x: f"{x / 1e9:.2f}"  # noqa: E731
        f, u = r["fsdp"], r["unplaced"]
        print(f"{arch} ({r['layers']} layers, {r['params']:,} params) over "
              f"{r['mesh']}, M={r['M']}: flat {gb(r['flat'])} GB "
              f"({r['columns']:,} columns a device); FSDP weights "
              f"{gb(f['weights'])} + grad {gb(f['grad'])} + gather "
              f"{gb(f['gather'])} + relayout {gb(f['relayout'])} (a group "
              f"{gb(r['peak_gather'])}) = "
              f"{gb(f['total'])} GB; unplaced weights {gb(u['weights'])} + "
              f"grad {gb(u['grad'])} = {gb(u['total'])} GB")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
