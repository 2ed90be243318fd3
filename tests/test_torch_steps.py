"""``launch.steps.build_step`` against the reference's ``build_step``.

The reference's step is lowered, compiled and run in one subprocess on a
forced 4-device CPU mesh, made with ``axis_types=Auto`` (jax 0.9's
default axis types refuse its ``with_sharding_constraint``), with the
params of its ``init_model`` and inputs drawn from a numpy seed, placed by
the compiled step's input shardings.  The subprocess starts with the
file's first test and runs beside the others.  The port's step runs the
same params and inputs on the same mesh in process.  Per case (granite-8b,
mamba2-780m, llama-3.2-vision-11b and phi3.5-moe-42b-a6.6b ``.reduced()``
in float32, train, prefill and decode at the shapes of
``tests/test_sharding.py`` over (data 2, model 2); starcoder2-3b,
whose 2 KV heads do not divide a model axis of 4, over (1, 4), the
head_dim fallback; and the decode of one sequence (``decode1``) of
gemma2-27b, gemma3-12b, starcoder2-3b and zamba2-2.7b over (2, 2),
whose KV sequence the rules split over ``data``):

* device (0, 0)'s argument bytes (the dry run's world) equal the
  reference's ``memory_analysis().argument_size_in_bytes`` exactly;
* prefill's logits and cache, decode's next token, logits and cache, and
  train's loss, accumulator, optimizer state and params over a
  non-applying and an applying microstep agree with the reference's
  within the tolerances stated at :data:`RTOL`.

Then, on the port alone: at a (1, 1) mesh the placed steps are the
unplaced ones bit for bit, and over 4 gloo ranks as a 2 x 2 grid the
placed prefill, decode and train steps give the bits of the same steps
with both model shards in process over the same data ranks, and the
sequence-split decode the bits of every shard in process
(``distributed.selfcheck.run_steps``).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig, InputShape
from repro_torch.convert import params_from_jax
from repro_torch.core.gba import path_unflatten, tree_paths
from repro_torch.distributed import process_group, selfcheck
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.programs import build_programs
from repro_torch.models import transformer as T
from test_torch_archs_train import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
SHAPES = {"train": InputShape("t", 64, 8, "train"),
          "prefill": InputShape("p", 64, 4, "prefill"),
          "decode": InputShape("d", 64, 8, "decode"),
          "decode1": InputShape("d1", 64, 1, "decode")}
CASES = [(a, k, (2, 2)) for a in ("granite-8b", "mamba2-780m",
                                  "llama-3.2-vision-11b",
                                  "phi3.5-moe-42b-a6.6b")
         for k in ("train", "prefill", "decode")]
CASES += [("starcoder2-3b", k, (1, 4)) for k in ("prefill", "decode")]
# batch 1: the rules split each KV sequence (and local ring) over data
CASES += [(a, "decode1", (2, 2)) for a in ("gemma2-27b", "gemma3-12b",
                                          "starcoder2-3b", "zamba2-2.7b")]
# decode: the reference's prefill of a 48-token prompt into a cache of 64
PROMPT = 48
# float32 tolerances: the loss as tests/test_torch_model_axis.py holds it,
# the accumulator and Adam's moments likewise; logits and caches through
# the model axis's other order of sums
LOSS_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-7
OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
# Adam's first step moves a param by lr * g / (|g| + 1e-8): where the
# gradient is within 100 eps of zero a float32 rounding of g moves the
# step, so there the params are held to the step's own size
LR, WELL_POSED = 1e-3, 1e-6
SPAWN_TIMEOUT = 300.0

_REF = r'''
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps as ST
from repro.launch.programs import init_train_state, ARCH_OPTIMIZER
from repro.models import transformer as JT
from repro.optim import get_optimizer

SHAPES = {"train": InputShape("t", 64, 8, "train"),
          "prefill": InputShape("p", 64, 4, "prefill"),
          "decode": InputShape("d", 64, 8, "decode"),
          "decode1": InputShape("d1", 64, 1, "decode")}

def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) if hasattr(k, "key") else f"#{k.idx}"
                     for k in p): np.asarray(x) for p, x in leaves}

def inputs(cfg, kind, B, S, rng):
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if kind == "train":
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return b

out = {}
prompt = int(sys.argv[2])
for case in sys.argv[3:]:
    arch, kind, mesh_name = case.split("|")
    try:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        shape = SHAPES[kind]
        mesh = jax.make_mesh(tuple(map(int, mesh_name.split("x"))),
                             ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        params = JT.init_model(jax.random.PRNGKey(0), cfg)
        for k, v in flat(params).items():
            out[f"{case}|param|{k}"] = v
        rng = np.random.default_rng(7)
        with mesh:
            fn, args = ST.build_step(cfg, shape, mesh)
            compiled = fn.lower(*args).compile()
            out[f"{case}|argbytes"] = np.array(
                compiled.memory_analysis().argument_size_in_bytes)
            sh = compiled.input_shardings[0]
            put = jax.device_put
            if kind == "train":
                batch = inputs(cfg, kind, shape.global_batch, shape.seq_len,
                               rng)
                opt = get_optimizer(ARCH_OPTIMIZER.get(cfg.name, "adam"),
                                    1e-3)
                state = init_train_state(params, opt)
                state["micro"] = jnp.array(6, jnp.int32)
                st, b = put(state, sh[0]), put(batch, sh[1])
                tok = put(jnp.array(0, jnp.int32), sh[2])
                st, l1 = compiled(st, b, tok)
                out[f"{case}|loss1"] = np.asarray(l1)
                for k, v in flat(st["acc"]).items():
                    out[f"{case}|acc1|{k}"] = v
                st, l2 = compiled(st, b, tok)
                out[f"{case}|loss2"] = np.asarray(l2)
                for part in ("params", "opt", "acc"):
                    for k, v in flat(st[part]).items():
                        out[f"{case}|{part}2|{k}"] = v
            elif kind == "prefill":
                batch = inputs(cfg, kind, shape.global_batch, shape.seq_len,
                               rng)
                logits, cache = compiled(put(params, sh[0]),
                                         put(batch, sh[1]))
                out[f"{case}|logits"] = np.asarray(logits)
                for k, v in flat(cache).items():
                    out[f"{case}|cache|{k}"] = v
            else:
                batch = inputs(cfg, "prefill", shape.global_batch, prompt,
                               rng)
                memory = batch.get("image_embeds")
                if "frames" in batch:
                    memory = JT.encode_audio(params, cfg, batch["frames"])
                _, cache = JT.prefill(
                    params, cfg, jnp.asarray(batch["tokens"]),
                    memory=None if memory is None else jnp.asarray(memory),
                    cache_len=shape.seq_len)
                for k, v in flat(cache).items():
                    out[f"{case}|cache0|{k}"] = v
                tok = jnp.asarray(batch["tokens"][:, -1:])
                nt, logits, cache = compiled(put(params, sh[0]),
                                             put(tok, sh[1]),
                                             put(cache, sh[2]))
                out[f"{case}|next"] = np.asarray(nt)
                out[f"{case}|logits"] = np.asarray(logits)
                for k, v in flat(cache).items():
                    out[f"{case}|cache|{k}"] = v
            for k, v in batch.items():
                out[f"{case}|batch|{k}"] = v
    except Exception as e:
        out[f"{case}|error"] = np.array(f"{type(e).__name__}: {e}"[:2000])
np.savez(sys.argv[1], **out)
'''


def _name(case) -> str:
    arch, kind, (w, t) = case
    return f"{arch}|{kind}|{w}x{t}"


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's steps in one subprocess, started with the file's
    first test; killed at the end if it still runs."""
    tmp = tmp_path_factory.mktemp("ref_steps")
    with open(tmp / "stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _REF, str(tmp / "out.npz"), str(PROMPT),
             *map(_name, CASES)], env=ENV, cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=err)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def got(reference):
    proc, tmp = reference
    code = proc.wait(timeout=600)
    assert code == 0, (tmp / "stderr").read_text()[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _tree(got: dict, prefix: str) -> dict:
    """The tree saved under ``prefix|path`` as float32/int tensors."""
    names = [k[len(prefix) + 1:] for k in got if k.startswith(prefix + "|")]
    return params_from_jax(path_unflatten(
        [tuple(n.split("/")) for n in names],
        [got[f"{prefix}|{n}"] for n in names]), device="cpu")


def _flat(tree) -> dict:
    return {"/".join(p): x for p, x in tree_paths(tree)}


def _cfg(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float,
           what) -> None:
    a, b = a.double(), b.double()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = (a - b).abs() > atol + rtol * b.abs()
    assert not bad.any(), (what, float((a - b).abs().max()))


def _check(got: dict, case, error: str) -> None:
    assert f"{_name(case)}|error" not in got, str(got[f"{_name(case)}|error"])
    assert f"{_name(case)}|argbytes" in got, error


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_device_argument_bytes_equal_the_references(got, case):
    """The dry run's argument bytes of device (0, 0), its held blocks and
    inputs: the reference's compiled argument bytes, exactly."""
    _check(got, case, "the reference did not run")
    arch, kind, (w, t) = case
    rec = dryrun.dryrun_step(_cfg(arch), SHAPES[kind],
                             Mesh(("data", "model"), (w, t)))
    assert rec["memory"]["argument_bytes"] == int(
        got[f"{_name(case)}|argbytes"])


def _run_train(step, cfg, params, batch):
    state = step.init_state(params)
    state["micro"] = 6
    b = step.place_batch(batch)
    state, l1 = step(state, b, 0)
    # the apply zeroes the accumulator in place: keep a copy
    acc1 = T._map(step.gather_params(state["acc"]), torch.clone)
    state, l2 = step(state, b, 0)
    return l1, acc1, l2, state


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_outputs_agree_with_the_references(got, case, one_torch_thread):
    """The port's step in process on the same mesh, params and inputs:
    prefill logits and every cache leaf, decode's next token, logits and
    cache, train's losses, accumulator after a non-applying microstep,
    and Adam's moments, count and params after the applying one (the
    accumulator zeroed)."""
    _check(got, case, "the reference did not run")
    arch, kind, (w, t) = case
    cfg, name = _cfg(arch), _name(case)
    mesh = Mesh(("data", "model"), (w, t))
    params = _tree(got, f"{name}|param")
    batch = {k[len(name) + 7:]: torch.from_numpy(v) for k, v in got.items()
             if k.startswith(f"{name}|batch|")}
    step, _ = steps.build_step(cfg, SHAPES[kind], mesh)
    if kind == "train":
        l1, acc1, l2, state = _run_train(step, cfg, params, batch)
        _close(l1, torch.from_numpy(got[f"{name}|loss1"]), LOSS_RTOL, 0, "l1")
        _close(l2, torch.from_numpy(got[f"{name}|loss2"]), LOSS_RTOL, 0, "l2")
        want_acc = _flat(_tree(got, f"{name}|acc1"))
        for k, v in _flat(acc1).items():
            _close(v, want_acc[k], RTOL, ATOL, ("acc1", k))
        assert state["micro"] == 8 and state["gstep"] == 1
        want_opt = _tree(got, f"{name}|opt2")
        assert int(state["opt"]["count"]) == int(want_opt["count"]) == 1
        for part in ("m", "v"):
            want = _flat(want_opt[part])
            for k, v in _flat(step.gather_params(state["opt"][part])).items():
                _close(v, want[k], RTOL, ATOL, (part, k))
        for k, v in _flat(step.gather_params(state["acc"])).items():
            assert not v.any(), k
        m = _flat(want_opt["m"])
        want = _flat(_tree(got, f"{name}|params2"))
        for k, v in _flat(step.gather_params(state["params"])).items():
            posed = m[k].abs() / 0.1 >= WELL_POSED
            _close(v[posed], want[k][posed], RTOL, ATOL, ("params", k))
            _close(v[~posed], want[k][~posed], 0, 2 * LR, ("params", k))
        return
    if kind == "prefill":
        logits, caches = step(step.place_params(params),
                              step.place_batch(batch))
    else:
        cache0 = _tree(got, f"{name}|cache0")
        nxt, logits, caches = step(step.place_params(params),
                                   batch["tokens"][:, -1:],
                                   step.place_cache(cache0))
        assert torch.equal(nxt, torch.from_numpy(got[f"{name}|next"]))
    _close(logits, torch.from_numpy(got[f"{name}|logits"]), OUT_RTOL,
           OUT_ATOL, "logits")
    want = _flat(_tree(got, f"{name}|cache"))
    mine = _flat(step.gather_cache(caches))
    assert mine.keys() == want.keys()
    for k, v in mine.items():
        _close(v, want[k], OUT_RTOL, OUT_ATOL, ("cache", k))


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_placed_steps_at_one_device_are_the_unplaced_steps(
        arch, one_torch_thread):
    """At a (1, 1) mesh the placed prefill, decode and train steps are
    ``transformer.prefill``, ``decode_step`` and the pytree step of
    ``build_programs`` bit for bit."""
    cfg = _cfg(arch)
    mesh = Mesh(("data", "model"), (1, 1))
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch, memory = {"tokens": toks}, None
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
        memory = T.encode_audio(params, cfg, batch["frames"])
    pre, _ = steps.build_step(cfg, InputShape("p", 16, 2, "prefill"), mesh)
    logits, caches = pre(pre.place_params(params), batch)
    want_l, want_c = T.prefill(params, cfg, toks, memory=memory)
    assert torch.equal(logits, want_l)
    dec, _ = steps.build_step(cfg, InputShape("d", 16, 2, "decode"), mesh)
    held = dec.place_params(params)
    tok = toks[:, -1:]
    for _ in range(2):
        nxt, logits, caches = dec(held, tok, caches)
        want_l, want_c = T.decode_step(params, cfg, tok, want_c)
        assert torch.equal(logits, want_l)
        tok = nxt
    for (p, a), (_, b) in zip(tree_paths(caches[0]), tree_paths(want_c)):
        assert torch.equal(a, b), p
    gba = GBAConfig(local_batch=2, buffer_size=2)
    train, _ = steps.build_step(cfg, InputShape("t", 16, 2, "train"), mesh,
                                gba)
    state = train.init_state(T._map(params, torch.clone))
    progs = build_programs(cfg, gba, params=T._map(params, torch.clone),
                           mode="pytree")
    ref = progs.state
    tb = {"tokens": toks, "labels": torch.roll(toks, 1, 1), **{
        k: v for k, v in batch.items() if k != "tokens"}}
    for i in range(2):
        state, loss = train(state, tb, i)
        ref, want = progs.step(ref, tb, i)
        assert torch.equal(loss, want)
    for (p, a), (_, b) in zip(tree_paths(train.gather_params(
            state["params"])), tree_paths(ref["params"])):
        assert torch.equal(a, b), p


def test_build_programs_places_the_pytree_step_as_build_step(
        one_torch_thread):
    """``build_programs(mode="pytree", workers=2, model=2)`` is
    ``build_step``'s train step over (2, 2), bit for bit: losses and the
    held blocks of params, accumulator and Adam's moments over an apply."""
    cfg = _cfg("granite-8b")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(8),
                          device="cpu")
    gba = GBAConfig(local_batch=2, buffer_size=2)
    progs = build_programs(cfg, gba, params=T._map(params, torch.clone),
                           mode="pytree", workers=2, model=2)
    step, _ = steps.build_step(cfg, InputShape("t", 16, 2, "train"),
                               Mesh(("data", "model"), (2, 2)), gba)
    assert progs.placement is not None and progs.model_axis is not None
    a, b = progs.state, step.init_state(T._map(params, torch.clone))
    gen = torch.Generator().manual_seed(9)
    for i in range(2):
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
                 for k in ("tokens", "labels")}
        a, la = progs.step(a, batch, i)
        b, lb = step(b, batch, i)
        assert torch.equal(la, lb)
    for part in ("params", "acc", "opt"):
        for (p, x), (_, y) in zip(tree_paths(a[part]), tree_paths(b[part])):
            assert torch.equal(x, y), (part, p)


def test_four_gloo_ranks_as_a_2x2_grid_give_the_in_process_bits():
    """4 gloo ranks as a (2, 2) grid: each rank's placed prefill (logits,
    its cache slices), decode (next token, logits, cache slices after two
    steps) and train step (losses, its params, accumulator and Adam blocks
    after a non-applying and an applying microstep) equal, bit for bit,
    the same steps with both model shards in process over the same data
    ranks; and the decode of one sequence split over ``data`` (``long``:
    next tokens, logits and this rank's cache slices after two steps)
    equal, bit for bit, the same decode with every shard in process."""
    cfg = _cfg("granite-8b")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(5),
                          device="cpu")
    with tempfile.TemporaryDirectory() as out:
        process_group.spawn(selfcheck.run_steps, 4, cfg, params, out,
                            device="cpu", timeout=SPAWN_TIMEOUT,
                            model_ranks=2)
        saved = [torch.load(f"{out}/rank{r}.pt") for r in range(4)]
    for r, runs in enumerate(saved):
        assert set(runs) == {"ranks", "process"}
        ranks, here = runs["ranks"], runs["process"]
        assert set(ranks) == {"prefill", "decode", "train", "long"}
        for kind in ranks:
            assert ranks[kind].keys() == here[kind].keys(), (r, kind)
            for k, v in ranks[kind].items():
                w = here[kind][k]
                assert v.dtype == w.dtype and v.shape == w.shape, (r, k)
                assert torch.equal(v.reshape(-1).view(torch.uint8),
                                   w.reshape(-1).view(torch.uint8)), (
                    r, kind, k)
