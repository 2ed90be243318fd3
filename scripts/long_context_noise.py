"""How far the placed long-context decode's bf16 logits sit from the
unplaced decode's, mesh by mesh, on one CUDA card.

    python3 scripts/long_context_noise.py [--dtype bfloat16|float32]

For each (arch, depth) below, at full width in bfloat16 and at
``long_500k``'s 524,288 positions, batch 1: the weights drawn from a
seed, a whole cache drawn as ``chip_smoke.py``'s phase 24 draws it
(``draw_cache``) at a position in the middle, and the unplaced
``decode_step`` run 4 greedy steps on a copy of it.  Then each listed
(data, model) mesh's placed decode (``launch.steps.build_step``, every
shard in process) is fed the same tokens from a copy of the same cache,
and the script prints, for each step, the largest |logit difference|
over the largest |logit| of the unplaced decode.  A (1, T) mesh moves
the float32 sums of the model axis alone, a (D, 1) mesh those of the
sequence split over ``data`` alone; "plain route" is the unplaced
decode with ``flash_decode`` swapped for its plain version, which moves
the sums of the global layers alone.  About a minute on an H100.

``--dtype float32`` runs the same decodes in float32 for starcoder2-3b
at full width and all 30 layers (its ring caches fit), over (1, 2),
(1, 4), (2, 1) and (4, 1): there the placed decode must agree with the
unplaced one to float32 rounding, so a deviation far above 1e-5 of the
largest logit is a wrong sum, not rounding.  Each mesh's line ends with
its largest deviation over the steps, unrounded.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

L = cs.LONG_LEN
# (arch, depth, meshes, position, seed, also the plain route)
CASES = (("gemma3-12b", 12, ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1)),
          L // 2 - 2, 10, True),
         ("zamba2-2.7b", 6, ((4, 1), (1, 2), (2, 2)), 3 * L // 4 - 2, 30,
          True),
         ("starcoder2-3b", 30, ((2, 1), (1, 2), (2, 2)), L // 2 - 2, 40,
          False),
         ("gemma2-27b", 4, ((2, 1), (1, 2), (2, 2)), L // 2 - 2, 41, False))
F32_CASES = (("starcoder2-3b", 30, ((1, 2), (1, 4), (2, 1), (4, 1)),
              L // 2 - 2, 40, False),)


def deviation(arch: str, depth: int, meshes, pos: int, seed: int,
              plain: bool, dtype: str = "bfloat16") -> dict:
    cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                              dtype=dtype)
    params = T.init_model(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    whole = cs.draw_cache(T.cache_shapes(cfg, 1, L), pos, seed + 1)
    first = torch.randint(0, cfg.vocab_size, (1, 1), dtype=torch.int32,
                          generator=torch.Generator("cuda").manual_seed(
                              seed + 2), device="cuda")
    tok, want, toks = first, [], []
    cache = T._map(whole, torch.clone)
    for _ in range(4):
        lg, cache = T.decode_step(params, cfg, tok, cache)
        want.append(lg.float())
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok)
    del cache
    scale = max(w.abs().max().item() for w in want)

    def steps_of(step_fn, cache) -> list:
        tok, out = first, []
        for i in range(4):
            lg, cache = step_fn(tok, cache)
            out.append((lg.float() - want[i]).abs().max().item() / scale)
            tok = toks[i]
        return out

    res = {}
    if plain:
        saved = ops.flash_decode
        ops.flash_decode = ref.flash_decode_ref
        try:
            res["plain route"] = steps_of(
                lambda t, c: T.decode_step(params, cfg, t, c),
                T._map(whole, torch.clone))
        finally:
            ops.flash_decode = saved
    for mesh in meshes:
        dec, _ = steps.build_step(cfg, InputShape("l", L, 1, "decode"),
                                  Mesh(("data", "model"), mesh))
        held = dec.place_params(params)
        res[f"{mesh[0]}x{mesh[1]}"] = steps_of(
            lambda t, c: dec(held, t, c)[1:], dec.place_cache(whole))
        del held, dec
        torch.cuda.empty_cache()
    del params, whole
    torch.cuda.empty_cache()
    return {"max_logit": scale, "by_mesh": res}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("long_context_noise: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}; {args.dtype}")
    t0 = time.perf_counter()
    f32 = args.dtype == "float32"
    fmt = "{:.3e}" if f32 else "{:.5f}"
    for arch, depth, meshes, pos, seed, plain in (F32_CASES if f32
                                                  else CASES):
        out = deviation(arch, depth, meshes, pos, seed, plain, args.dtype)
        print(f"{arch} depth {depth} from pos {pos}, {args.dtype}, largest "
              f"logit {out['max_logit']!r}: " + "; ".join(
                  f"{k} {', '.join(fmt.format(x) for x in v)} "
                  f"(max {max(v)!r})" for k, v in out["by_mesh"].items()),
              flush=True)
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
