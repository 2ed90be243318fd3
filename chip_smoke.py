#!/usr/bin/env python3
"""Drive the PyTorch port's recsys scoring path on one CUDA card.

    python3 chip_smoke.py

Runs the paper-scale serving configuration of
``benchmarks/bench_tab52_qps.py`` (an embedding table of 1,000,000 x 64
f32 rows, a 64 -> 64 -> 32 -> 1 tower, a 4096-row hot-ID cache, Zipf(1.2)
requests of (8, 16) raw ids over a 512-id hot pool, live sync of 2
coalesced publishes touching 16 rows each every 8 batches) through
``repro_torch`` alone, with random weights from a seed:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a and
   print each kernel's registers, shared memory and spills;
3. each kernel against its plain PyTorch version on the card;
4. serving from a static source: cache hits launch nothing, and a
   cache-less engine gives bit-identical scores through the kernel;
5. serving from a live source: bit-identical to a fresh engine at every
   sync;
6. a checkpoint round trip scores bit-identically;
7. timing: each kernel, its plain version and the PyTorch library call
   with CUDA events, and the engine's score latency;
8. one JSON line of the kernels, then the result line.

Every count of kernel launches is set to 0 before phase 4 and read after
phase 6, so ``launches`` counts the serving path alone.  Any failure raises
and the script exits non-zero without the result line.  It needs a CUDA
card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

# bench_tab52_qps.py:93-100
V, DIM, MLP = 1_000_000, 64, (64, 32)
HOT, CACHE = 512, 4096
B, F = 8, 16
SYNC_EVERY, PUBS_PER_SYNC, TOUCH = 8, 2, 16
NUM_BATCHES = 64
LATENCY_BATCHES = 1024

# H100 SXM (NVIDIA data sheet): HBM rate and float32 rate outside the
# tensor cores, for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bf16 outputs: the kernel and the plain version both sum in f32 and round
# once, so where their f32 sums straddle a rounding boundary they differ by
# one bf16 ulp, at most 2**-7 of |x|.  A running sum kept in bf16 misses
# this on about a quarter of the outputs of the bf16 cases.
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6

TIMED_SHAPES = ((128, 1), (4096, 16))   # serving miss pool, bulk pool
TIMED_ID_SETS = 16     # cycled so the (4096, 16) pools span 268 MB > L2
TIMED_REPS = 100


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(n: int, title: str) -> None:
    print(f"== phase {n}: {title}", flush=True)


def bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def hot_batch(rng: np.random.Generator, hot: np.ndarray) -> np.ndarray:
    """(B, F) raw ids, Zipf-skewed inside the hot pool
    (bench_tab52_qps.py:103-106)."""
    ranks = rng.zipf(1.2, size=(B, F)) - 1
    return hot[np.minimum(ranks, hot.shape[0] - 1)]


def device_phase() -> str:
    phase(1, "device")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {name}; count {count}; torch {torch.__version__}; "
          f"cuda {torch.version.cuda}")
    for line in smi.splitlines()[:1]:
        print(line)
    return name


def build_phase(runtime) -> None:
    phase(2, "build")
    t0 = time.perf_counter()
    libs = runtime.build()
    for name, lib in libs.items():
        runtime.load_library(name)
        print(f"built {lib.relative_to(ROOT)}")
    print(f"build and load took {time.perf_counter() - t0:.1f} s")
    for line in runtime.build_log().splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())
    try:                        # cudaErrorInvalidValue is reported by name
        runtime.check(1, "an error code")
    except RuntimeError as e:
        check("invalid argument" in str(e), f"CUDA error text: {e}")
    else:
        check(False, "runtime.check raises on a CUDA error")


def kernel_cases(gen: torch.Generator, big: torch.Tensor) -> list:
    """(name, ids, table) on the card, at the serving path's shapes and at
    the edges of the kernel's contract."""
    dev = big.device

    def ids(b, f, hi):
        return torch.randint(0, hi, (b, f), generator=gen, device=dev,
                             dtype=torch.int32)

    def table(v, d, dtype=torch.float32):
        return (torch.randn((v, d), generator=gen, device=dev)
                * 0.01).to(dtype)

    miss = ids(128, 1, V)
    miss[100:] = V                               # fetch_rows' sentinel pad
    odd = ids(64, 16, V)
    odd[:, ::3] = -1
    odd[:, 1::5] = V
    odd[:, 2::7] = V + 12345
    odd[0] = -7                                  # a bag of no valid id
    dup = ids(64, 16, V)
    dup[:, 8:] = dup[:, :8]                      # each id twice in its bag
    dup[1] = dup[1, 0]                           # one id 16 times
    return [
        ("serving miss (128, 1) + sentinel", miss, big),
        ("bulk pool (4096, 16)", ids(4096, 16, V), big),
        ("F=1 bulk (4096, 1)", ids(4096, 1, V), big),
        ("negative, >= V and sentinel ids", odd, big),
        ("duplicates inside a bag", dup, big),
        ("D=80 (not a tile multiple)", ids(256, 16, 50_000),
         table(50_000, 80)),
        ("D=13 (scalar loads)", ids(256, 8, 10_000), table(10_000, 13)),
        ("bf16 table (4096, 16)", ids(4096, 16, V), big.to(torch.bfloat16)),
        ("bf16 F=1 (128, 1)", ids(128, 1, V), big.to(torch.bfloat16)),
        ("bf16 D=20 (scalar loads)", ids(256, 16, 10_000),
         table(10_000, 20, torch.bfloat16)),
    ]


def bf16_summed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The pooled lookup with the running sum rounded to bf16 after every
    add: what a kernel that broke the f32-accumulation contract gives."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0).long()]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    acc = torch.zeros_like(rows[:, 0])
    for f in range(ids.shape[1]):
        acc = acc + rows[:, f]
    return acc


def kernel_phase(embedding_bag, embedding_bag_ref, big, gen) -> float:
    phase(3, "kernel vs plain version on the card")
    max_err = 0.0
    for name, ids, table in kernel_cases(gen, big):
        out = embedding_bag(ids, table)
        ref = embedding_bag_ref(ids, table)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == table.dtype,
              f"{name}: shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        if ids.shape[1] == 1:
            ok = torch.equal(out.view(torch.int16 if out.dtype ==
                                      torch.bfloat16 else torch.int32),
                             ref.view(torch.int16 if ref.dtype ==
                                      torch.bfloat16 else torch.int32))
            tol = "bit-exact"
        elif table.dtype == torch.bfloat16:
            ok = torch.allclose(out.float(), ref.float(), rtol=BF16_RTOL,
                                atol=BF16_ATOL)
            tol = f"rtol={BF16_RTOL} atol={BF16_ATOL} in f32"
            # the tolerance catches a kernel that sums in bf16
            check(not torch.allclose(bf16_summed(ids, table).float(),
                                     ref.float(), rtol=BF16_RTOL,
                                     atol=BF16_ATOL),
                  f"{name}: a bf16 running sum stays within the tolerance")
        else:
            ok = torch.allclose(out, ref, rtol=1e-5, atol=1e-6)
            tol = "rtol=1e-5 atol=1e-6"
        valid = (ids >= 0) & (ids < table.shape[0])
        empty = ~valid.any(dim=1)
        if empty.any():
            ok = ok and bool((out[empty] == 0).all())
        print(f"  {name}: ids {tuple(ids.shape)} table "
              f"{tuple(table.shape)} {str(table.dtype)[6:]}: max|err| "
              f"{err:.3g} ({tol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"kernel vs plain version: {name}")
        max_err = max(max_err, err)
    return max_err


def serving_static_phase(S, params, hot, counters) -> dict:
    phase(4, "serving, static source")
    cfg = S.ServingConfig(cache_capacity=CACHE)
    eng = S.RecsysScoringEngine(S.StaticSource(params), config=cfg)
    rng = np.random.default_rng(0)
    eng.score(hot.reshape(1, -1))       # warm: one pool over the hot set
    eng.latencies_us.clear()
    per_call = []
    for _ in range(NUM_BATCHES):
        l0 = counters()["launches"]
        out = eng.score(hot_batch(rng, hot))
        per_call.append(counters()["launches"] - l0)
        check(out.shape == (B,) and bool(np.isfinite(out).all()),
              "scores finite, shape (B,)")
    probe = hot_batch(rng, hot)
    eng.score(probe)                            # make the probe resident
    before = counters()
    hit_scores = eng.score(probe)
    check(counters() == before, "an all-hit batch launches no kernel")
    nocache = S.RecsysScoringEngine(S.StaticSource(params),
                                    config=S.ServingConfig(cache_capacity=0))
    miss_scores = nocache.score(probe)
    after = counters()
    check(after["launches"] == before["launches"] + 1
          and after["calls"] == before["calls"] + 1,
          "a cache-less engine launches the kernel once per score")
    check(np.array_equal(bits(hit_scores), bits(miss_scores)),
          "cache and no-cache scores bit-identical")
    st = eng.stats()
    print(f"  hit_rate {st['hit_rate']:.4f}; p50 {st['p50_us']:.1f} us, "
          f"p99 {st['p99_us']:.1f} us over {NUM_BATCHES} requests; "
          f"launches per score: {np.bincount(per_call).tolist()} "
          f"(count of requests with 0, 1, ... launches)")
    check(max(per_call) <= 1, "at most one launch per score")
    return {"engine": eng, "probe": probe, "probe_scores": hit_scores,
            "stats": st, "launch_hist": np.bincount(per_call).tolist()}


def serving_live_phase(S, params, hot, hash_ids) -> dict:
    phase(5, "serving, live source")
    cfg = S.ServingConfig(cache_capacity=CACHE)
    chan = S.UpdateChannel()
    live = S.LiveSource(chan, params, sync_interval=cfg.sync_interval,
                        start=False)
    eng = S.RecsysScoringEngine(live, config=cfg)
    rng = np.random.default_rng(1)
    check_rng = np.random.default_rng(2)
    eng.score(hot.reshape(1, -1))
    eng.latencies_us.clear()
    table = params["table"]
    step = max_lag = syncs = 0
    for i in range(NUM_BATCHES):
        eng.score(hot_batch(rng, hot))
        if (i + 1) % SYNC_EVERY:
            continue
        for _ in range(PUBS_PER_SYNC):
            step += 1
            touch = hash_ids(torch.from_numpy(rng.choice(HOT, TOUCH)), V)
            new = table.table.clone()
            new.index_put_((touch.long().to(new.device),),
                           torch.tensor(0.01, device=new.device),
                           accumulate=True)
            table = table._replace(table=new)
            chan.publish({"table": table, "mlp": params["mlp"]}, step,
                         touched_ids=touch.numpy())
        max_lag = max(max_lag, live.freshness_lag_steps())
        snap = live.sync_now()
        syncs += 1
        check(snap.version == syncs + 1, "one version per sync")
        fresh = S.RecsysScoringEngine(S.StaticSource(snap.params),
                                      config=cfg)
        batch = hot_batch(check_rng, hot)
        check(np.array_equal(bits(eng.score(batch)),
                             bits(fresh.score(batch))),
              f"live = fresh at sync {syncs}")
    st = eng.stats()
    check(st["syncs_adopted"] == syncs, "every sync adopted")
    print(f"  {syncs} syncs, live = fresh bit-identical at each; hit_rate "
          f"{st['hit_rate']:.4f}; p50 {st['p50_us']:.1f} us, p99 "
          f"{st['p99_us']:.1f} us over {len(eng.latencies_us)} requests; "
          f"freshness_lag_steps {max_lag}; coalesced {chan.coalesced}; "
          f"invalidations {eng.cache.invalidations}")
    eng.close()
    return {"stats": st, "syncs": syncs, "max_lag": max_lag}


def checkpoint_phase(S, save_pytree, params, static) -> None:
    phase(6, "checkpoint round trip")
    ckpt_dir = WORK / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        save_pytree(str(ckpt_dir / "ckpt_00000007.npz"), params)
        src = S.StaticSource.from_checkpoint(str(ckpt_dir))
        check(src.snapshot().step == 7, "newest checkpoint step")
        eng = S.RecsysScoringEngine(src, config=S.ServingConfig(
            cache_capacity=CACHE))
        got = eng.score(static["probe"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(np.array_equal(bits(got), bits(static["probe_scores"])),
          "checkpoint scores bit-identical")
    print("  restored engine scores bit-identical")


def reference_check(params, probe, hash_ids,
                    embedding_bag_ref) -> np.ndarray:
    """Reference scores of the probe: the plain lookup, then the tower in
    float64 on the host."""
    hashed = hash_ids(torch.from_numpy(probe), V)
    x = embedding_bag_ref(hashed.to(params["table"].table.device),
                          params["table"].table).cpu().double()
    n = len(MLP) + 1
    for i in range(n):
        x = x @ params["mlp"][f"w{i}"].cpu().double() \
            + params["mlp"][f"b{i}"].cpu().double()
        if i < n - 1:
            x = torch.relu(x)
    return torch.sigmoid(x[:, 0]).numpy()


def time_ms(fn, id_sets, table, cycles_per_ms) -> tuple[float, float]:
    """(device ms, host-paced ms) per call, from CUDA events around
    ``TIMED_REPS`` calls.  Host-paced: the calls are issued as fast as the
    host can, so a call the host issues slower than the device runs it
    reads as the host's time.  Device: a sleep kernel first holds the
    device for twice the host-paced loop, so every call is queued before
    the first one runs and the events see the device's time alone."""
    for i in range(10):
        fn(id_sets[i % len(id_sets)], table)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold_ms in (0.0, None):
        if hold_ms is None:
            hold_ms = 2 * out[0] * TIMED_REPS + 1.0
            torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        for i in range(TIMED_REPS):
            fn(id_sets[i % len(id_sets)], table)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / TIMED_REPS)
    return out[1], out[0]


def sleep_cycles_per_ms() -> float:
    """Clock rate that ``torch.cuda._sleep`` spins at."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def bound_ms(ids: torch.Tensor, table: torch.Tensor) -> tuple[float, str]:
    """Least time for this call: the row of each distinct valid id read
    once, the ids read once, the output written once, against one add per
    valid (bag, id) entry and element."""
    mask = (ids >= 0) & (ids < table.shape[0])
    rows = int(torch.unique(ids[mask]).numel())
    entries = int(mask.sum())
    d, item = table.shape[1], table.element_size()
    nbytes = rows * d * item + ids.numel() * 4 + ids.shape[0] * d * item
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = entries * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def device_busy(eng, batches) -> dict:
    """Device time of the kernels and copies of ``score`` calls over their
    wall time, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for raw in batches:
            eng.score(raw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1 - busy / wall_us) if busy else None,
            "top_us": {k: v for k, v in top}}


def timing_phase(embedding_bag, embedding_bag_ref, big, gen, static, S,
                 params) -> dict:
    phase(7, "timing")
    lib = torch.nn.functional.embedding_bag
    fns = {"kernel": embedding_bag, "plain": embedding_bag_ref,
           "library": lambda i, t: lib(i, t, mode="sum")}
    cycles_per_ms = sleep_cycles_per_ms()
    shapes = []
    for b, f in TIMED_SHAPES:
        id_sets = [torch.randint(0, V, (b, f), generator=gen,
                                 device=big.device, dtype=torch.int32)
                   for _ in range(TIMED_ID_SETS)]
        check(torch.allclose(embedding_bag(id_sets[0], big),
                             fns["library"](id_sets[0], big),
                             rtol=1e-5, atol=1e-6), "library call agrees")
        dev = {k: [] for k in fns}
        host = {k: [] for k in fns}
        for _ in range(3):                      # in turns, median of 3
            for k, fn in fns.items():
                d, h = time_ms(fn, id_sets, big, cycles_per_ms)
                dev[k].append(d)
                host[k].append(h)
        med = {k: float(np.median(v)) for k, v in dev.items()}
        bnd, by = bound_ms(id_sets[0], big)
        row = {"shape": [b, f], "ms": med["kernel"],
               "plain_ms": med["plain"], "library_ms": med["library"],
               "bound_ms": bnd, "bound_by": by, "device_runs_ms": dev,
               "host_paced_ms": {k: float(np.median(v))
                                 for k, v in host.items()}}
        shapes.append(row)
        print(f"  ({b}, {f}) over ({V}, {DIM}) f32, device ms per call: "
              f"kernel {med['kernel']!r}, plain {med['plain']!r}, "
              f"F.embedding_bag {med['library']!r}, bound {bnd!r} ({by}); "
              f"host-paced ms per call: {json.dumps(row['host_paced_ms'])}"
              f"; device runs: {json.dumps(dev)}")

    # score latency at steady state: the static engine of phase 4 (cache
    # warm) and a cache-less engine (every request launches the kernel)
    rng = np.random.default_rng(3)
    hot = np.arange(HOT, dtype=np.int64)
    lat = {}
    nocache = S.RecsysScoringEngine(S.StaticSource(params),
                                    config=S.ServingConfig(cache_capacity=0))
    for name, eng in (("cached", static["engine"]), ("no_cache", nocache)):
        eng.latencies_us.clear()
        eng.stages_us.clear()
        for _ in range(LATENCY_BATCHES):
            eng.score(hot_batch(rng, hot))
        us = np.asarray(eng.latencies_us)
        stages = np.median(np.asarray(eng.stages_us), axis=0)
        batches = [hot_batch(rng, hot) for _ in range(256)]
        lat[name] = {"n": int(us.size),
                     "p50_us": float(np.percentile(us, 50)),
                     "p90_us": float(np.percentile(us, 90)),
                     "p99_us": float(np.percentile(us, 99)),
                     "hit_rate": eng.stats()["hit_rate"],
                     "stages_p50_us": dict(zip(
                         ("hash", "lookup", "tower"), stages.tolist())),
                     "profile": device_busy(eng, batches)}
        print(f"  score latency, {name}: {json.dumps(lat[name])}")
    return {"shapes": shapes, "latency": lat}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch.serving as S
    from repro_torch.checkpoint import save_pytree
    from repro_torch.embeddings import hash_ids
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.ref import embedding_bag_ref

    t_start = time.perf_counter()
    kind = device_phase()
    build_phase(runtime)

    gen = torch.Generator(device="cuda").manual_seed(1)
    # init_table's scale: pooled sums of F rows then round at the 1e-8
    # level, well inside the stated f32 tolerance
    big = torch.randn((V, DIM), generator=gen, device="cuda") * 0.01
    max_err = kernel_phase(embedding_bag, embedding_bag_ref, big, gen)

    def counters():
        return {"launches": embedding_bag.launches,
                "calls": ops.kernel_calls["pooled_lookup"]}

    params = S.init_scoring_params(
        V, DIM, MLP, generator=torch.Generator().manual_seed(0),
        device="cuda")
    hot = np.arange(HOT, dtype=np.int64)

    # the serving path, phases 4-6: every count starts at 0 here
    ops.kernel_calls.clear()
    embedding_bag.launches = 0
    static = serving_static_phase(S, params, hot, counters)
    want = reference_check(params, static["probe"], hash_ids,
                           embedding_bag_ref)
    check(np.allclose(static["probe_scores"], want, rtol=1e-5, atol=1e-6),
          "scores agree with a float64 host reference")
    live = serving_live_phase(S, params, hot, hash_ids)
    checkpoint_phase(S, save_pytree, params, static)
    torch.cuda.synchronize()
    path_launches = embedding_bag.launches
    print(f"serving path: embedding_bag launches {path_launches}, "
          f"pooled_lookup calls {ops.kernel_calls['pooled_lookup']}")
    check(path_launches > 0, "the serving path launched embedding_bag")

    timing = timing_phase(embedding_bag, embedding_bag_ref, big, gen,
                          static, S, params)

    phase(8, "kernels")
    main_shape = timing["shapes"][0]
    print(json.dumps({
        "serving": {"static": static["stats"], "live": live["stats"],
                    "live_syncs": live["syncs"],
                    "freshness_lag_steps": live["max_lag"],
                    "launches_per_score_hist": static["launch_hist"],
                    "latency": timing["latency"]},
        "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": [{
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:297",
        "launches": path_launches,
        "max_abs_err": max_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "at": main_shape["shape"],
        "shapes": timing["shapes"],
        "ok": True,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
