"""Training the two architectures with ``cross`` layers on the CPU against
the JAX package: llama-3.2-vision-11b (a cross layer every 5th layer, over
stub image embeddings) and seamless-m4t-medium (an audio encoder, then
cross layers over its output) at ``.reduced()`` (16 image tokens; 32
frames through 2 encoder layers).

The loss is each package's own ``_loss_from_batch``: a batch carries
``image_embeds``, or ``frames`` that the params' encoder runs through
inside the loss, so the encoder's leaves take a gradient.  Memories and
frames are seeded Normal draws, never the launcher's zeros: over a zero
memory the cross-attention's keys and values are zero (its weights have
no bias), so ``xattn``'s weights take no gradient, and zero frames run
the encoder's layernorms at zero variance.  The launcher's own zero
memory is run by the CLI tests, which hold finite losses.

Parameters are drawn by the port's ``init_model`` at seed 6, the filled
leaves (norm scales and biases) then drawn at 0.1 N(0, 1) about their
fills, and carried to the reference as jax arrays; batches come from the
numpy LM stream.  The reference runs jitted, outside any mesh, its fused
step applying through ``gba_apply_ref`` (``tests/test_torch_archs_fused.
py``).

Tolerances are those of ``tests/test_torch_archs_train.py`` and
``tests/test_torch_archs_fused.py`` (``TOL``): gradients within 1e-5
(float32) or 2**-5 (bfloat16) of each leaf's largest magnitude; the
pytree step's losses within rtol 1e-6, params within lr / 4 with at most
1 element in 1,000 beyond rtol 1e-5 / atol 1e-7, its optimizer state
within 1e-3 of its leaf's largest; the fused step's losses within rtol
1e-6 (5e-4 in bfloat16), flat params and accumulator within rtol 1e-5 /
atol 1e-7 (bfloat16: params within one bf16 ulp plus 2**-12, the
accumulator within rtol 1e-2); layer groups exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.core.flat_sharded import ShardedFlatLayout as JaxShardedLayout
from repro.core.flat_sharded import path_names
from repro.launch import programs as jax_programs
from repro.launch.programs import build_programs as jax_build_programs
from repro.models import transformer as JT
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.core.flat_sharded import TILE, ShardedFlatLayout
from repro_torch.core.gba import FlatLayout, path_unflatten, tree_paths
from repro_torch.data import make_lm_stream
from repro_torch.distributed import process_group
from repro_torch.kernels import ops
from repro_torch.launch import programs, train
from repro_torch.launch.programs import build_programs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from test_torch_archs_fused import jax_apply_by_its_reference  # noqa: F401
from test_torch_archs_train import (  # noqa: F401 (fixtures)
    IOTA, LR, M, TOKENS, TOL, _close_to_max, _outside_any_mesh,
    one_torch_thread)

ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
AUDIO = "seamless-m4t-medium"
B, S, SEED = 2, 24, 6
SPAWN_TIMEOUT = 240.0          # seconds a spawned world may take
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_MODELS = {}


def _model(arch, dtype="float32"):
    """Both ``.reduced()`` configs in ``dtype``, the port's parameters
    (the fills drawn) and the same values as jax arrays; one draw a
    module, handed out as copies."""
    if (arch, dtype) not in _MODELS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        p = T.init_model(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
        top, block = T.model_spec(cfg)
        specs = [s for _, s in tree_paths({**top, "blocks": block})]
        gen = torch.Generator().manual_seed(SEED + 100)
        for (_, t), spec in zip(tree_paths(p), specs, strict=True):
            if spec.scale is None:
                t.copy_(spec.fill + 0.1 * torch.randn(t.shape, generator=gen))
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype=dtype)
        _MODELS[arch, dtype] = (jcfg, cfg, p)
    jcfg, cfg, p = _MODELS[arch, dtype]
    jp = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), dtype=_JDT[t.dtype]), p)
    return jcfg, cfg, jp, T._map(p, torch.clone)


def _memory_key(cfg):
    return "image_embeds" if cfg.family == "vlm" else "frames"


def _batches(cfg, n=len(TOKENS), rows=B):
    """``n`` batches of the LM stream (seed 0), each with a memory of its
    own: a seeded Normal draw rounded to the model dtype, as numpy
    float32."""
    stream = make_lm_stream(cfg.vocab_size, S, rows, seed=0)
    length = cfg.num_image_tokens or cfg.encoder_frames
    dt = L.dtype_of(cfg)
    out = []
    for i in range(n):
        x = np.random.default_rng(50 + i).standard_normal(
            (rows, length, cfg.d_model)).astype(np.float32)
        x = torch.from_numpy(x).to(dt).float().numpy()
        out.append({**stream.batch(i), _memory_key(cfg): x})
    return out


def _port(b, cfg):
    return {k: torch.from_numpy(v).to(L.dtype_of(cfg)) if v.dtype.kind == "f"
            else torch.from_numpy(v) for k, v in b.items()}


def _jax(b, jcfg):
    return {k: jnp.asarray(v, dtype=jnp.dtype(jcfg.dtype))
            if v.dtype.kind == "f" else jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_over_a_memory_match_jax_grad(arch, dtype):
    """``_loss_from_batch`` over a drawn memory, and every leaf's gradient
    against ``jax.grad`` of the reference's in its flat order: the cross
    layer's ``xattn`` and ``lnx``, and seamless's ``encoder`` and
    ``enc_norm``, each nonzero."""
    jcfg, cfg, jp, p = _model(arch, dtype)
    b = _batches(cfg, 1)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda jp, b: jax_programs._loss_from_batch(jp, jcfg, b)))(
        jp, _jax(b, jcfg))
    loss, grads = programs._grads_of(programs.make_loss_fn(cfg), p,
                                     _port(b, cfg))
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=TOL[dtype][1])
    paths, leaves = zip(*tree_paths(p))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [path_names(k) for k, _ in flat] == list(paths)
    cross = f"l{len(cfg.block_pattern) - 1}"
    moved = {path: bool(g.abs().max() > 0) for path, g in zip(
        paths, (x for _, x in tree_paths(grads)))}
    for path, x, g, (_, want) in zip(paths, leaves,
                                     (x for _, x in tree_paths(grads)), flat):
        assert g.dtype == x.dtype, path
        _close_to_max(g.float().numpy(), want, TOL[dtype][0], "/".join(path))
        if path[:2] in (("blocks", cross),) and path[2] in ("xattn", "lnx") \
                or path[0] in ("encoder", "enc_norm"):
            assert moved[path], f"{path}: a zero gradient"
    assert any(path[0] == "encoder" for path in paths) == (arch == AUDIO)


# ---------------------------------------------------------------------------
# the pytree and fused GBA steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pytree_step_over_a_memory_matches_jax(arch):
    """8 microsteps of ``build_programs(mode="pytree")`` at M = 4 (Adam at
    lr 1e-3, float32 accumulators), each batch with its own memory,
    microstep 5's token stale beyond iota."""
    jcfg, cfg, jp, p = _model(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="pytree",
                               params=jp,
                               optimizer=jax_get_optimizer("adam", LR))
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="pytree",
                           optimizer=get_optimizer("adam", LR))
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for b, token in zip(_batches(cfg), TOKENS):
        js, loss = jprogs.step(js, _jax(b, jcfg),
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, _port(b, cfg), token)
        tl.append(loss.item())
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=TOL["float32"][1])
    assert (ts["micro"], ts["gstep"]) == (int(js["micro"]),
                                          int(js["gstep"])) == (8, 2)
    layout = FlatLayout.from_params(p)
    for what, jtree, ttree in (("acc", js["acc"], ts["acc"]),
                               ("m", js["opt"]["m"], ts["opt"]["m"]),
                               ("v", js["opt"]["v"], ts["opt"]["v"])):
        for path, got, want in zip(layout.paths, layout.leaves(ttree),
                                   jax.tree.leaves(jtree)):
            _close_to_max(got.numpy(), want, 1e-3, f"{what} {path}")
    beyond = 0
    for path, got, want in zip(layout.paths, layout.leaves(ts["params"]),
                               jax.tree.leaves(js["params"])):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=LR / 4,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got - want) > 1e-5 * np.abs(want) + 1e-7).sum())
    assert beyond <= layout.total / 1000, beyond


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_over_a_memory_matches_jax(arch, dtype,
                                              jax_apply_by_its_reference):
    """8 microsteps of ``build_programs(mode="fused")`` at M = 4, iota 4,
    microstep 5's token stale and dropped at the second apply; one
    ``gba_apply`` at microsteps 4 and 8 alone; the cross layer's and the
    encoder's leaves moved by the first apply."""
    jcfg, cfg, jp, p = _model(arch, dtype)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                               params=jp, lr=LR)
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="fused",
                           lr=LR)
    before = T._map(p, torch.clone)
    js, ts, jl, tl, applied = jprogs.state, progs.state, [], [], []
    for b, token in zip(_batches(cfg), TOKENS):
        js, loss = jprogs.step(js, _jax(b, jcfg),
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        calls = ops.kernel_calls["gba_apply_flat"]
        ts, loss = progs.step(ts, _port(b, cfg), token)
        tl.append(loss.item())
        applied.append(ops.kernel_calls["gba_apply_flat"] - calls)
        if len(tl) == M:
            cross = ts["params"]["blocks"][f"l{len(cfg.block_pattern) - 1}"]
            was = before["blocks"][f"l{len(cfg.block_pattern) - 1}"]
            moved = [(cross[k], was[k]) for k in ("xattn", "lnx")]
            if arch == AUDIO:
                moved += [(ts["params"][k], before[k])
                          for k in ("encoder", "enc_norm")]
            for new, old in moved:
                for (path, a), (_, b0) in zip(tree_paths(new),
                                              tree_paths(old)):
                    assert not torch.equal(a, b0), f"{path} did not move"
    assert applied == [0, 0, 0, 1, 0, 0, 0, 1]
    np.testing.assert_allclose(tl, jl, rtol=TOL[dtype][1])
    buf = ts["buffer"]
    assert (buf["fill"], buf["step"]) == (int(js["buffer"]["fill"]),
                                          int(js["buffer"]["step"])) == (8, 2)
    np.testing.assert_array_equal(buf["tokens"].numpy(), [1, -5, 1, 1])
    flat = progs.layout.ravel(ts["params"]).numpy()
    jflat = np.asarray(jprogs.layout.ravel(js["params"]))
    accum, jaccum = ts["accum"].numpy(), np.asarray(js["accum"])
    if dtype == "float32":
        np.testing.assert_allclose(flat, jflat, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(accum, jaccum, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(flat, jflat, rtol=2.0**-7, atol=2.0**-12)
        np.testing.assert_allclose(accum, jaccum, rtol=1e-2)


# ---------------------------------------------------------------------------
# layer groups and the worker-parallel steps' rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_seamless_layer_groups_match_the_reference(shards):
    """``param_group_key`` gives the encoder and its norm one group each,
    as the reference's does, and the layer-grouped layout has the
    reference's groups, in its order, at its extents."""
    _, _, jp, p = _model(AUDIO)
    for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = path_names(path)
        assert T.param_group_key(names) == JT.param_group_key(names)
    lay = ShardedFlatLayout.from_params(p, shards, TILE,
                                        group_by=T.param_group_key)
    ref = JaxShardedLayout.from_params(jp, shards, TILE,
                                       group_by=JT.param_group_key)
    assert lay.group_keys == ref.group_keys == (
        "blocks.l0", "embed", "enc_norm", "encoder", "final_norm", "head")
    for name in ("leaf_group", "group_sizes", "group_shard_sizes",
                 "group_local_offsets", "offsets", "sizes", "padded_sizes",
                 "padded_total", "shard_size"):
        assert getattr(lay, name) == getattr(ref, name), name


@pytest.mark.parametrize("mode", ["wire", "sync_psum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_worker_takes_its_own_rows_of_the_memory(arch, mode,
                                                      monkeypatch):
    """The worker-parallel steps split every batch entry by rows: each of
    4 workers' losses sees its own rows of the tokens, labels and memory,
    and the step's loss is their mean (every token fresh)."""
    _, cfg, _, p = _model(arch)
    seen, loss_of = [], programs._loss_from_batch

    def spy(params, cfg, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return loss_of(params, cfg, batch)
    monkeypatch.setattr(programs, "_loss_from_batch", spy)
    gba = GBAConfig(local_batch=1, buffer_size=4, staleness_tolerance=IOTA)
    progs = build_programs(cfg, gba, params=p, mode=mode, lr=LR, workers=4)
    batch = _port(_batches(cfg, 1, rows=4)[0], cfg)
    tokens = torch.zeros((4,), dtype=torch.int32)
    if mode == "wire":
        *_, loss = progs.warm_step(progs.state["param_flat"],
                                   progs.state["accum"], batch, tokens, 0)
    else:
        *_, loss = progs.step(progs.state["params"], progs.state["opt"],
                              batch, tokens, 0)
    assert len(seen) == 4
    for w, chunk in enumerate(seen):
        assert set(chunk) == set(batch)
        for k, v in chunk.items():
            assert torch.equal(v, batch[k][w:w + 1]), (w, k)
    with torch.no_grad():
        each = [loss_of(T._map(p, torch.clone), cfg, c) for c in seen]
    torch.testing.assert_close(loss, sum(each) / 4, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the launcher, with the reference launcher's zero memory
# ---------------------------------------------------------------------------

CLI = {"pytree": [],
       "fused": ["--fused"],
       "fused-mesh": ["--fused", "--mesh", "4x1"],
       "wire-int8": ["--fused", "--mesh", "4x1", "--compress", "int8",
                     "--compress-warmup", "2"]}


@pytest.mark.parametrize("mode", list(CLI))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_every_mode_on_the_cpu(arch, mode, capsys):
    """``launch.train --arch X --reduced`` in each mode, the batches
    carrying the launcher's zero memory: finite losses; ``gba_apply``
    once an apply (one layout), 4 times (4 shards), or 4 times a step
    (the wire)."""
    steps = 4 if mode == "wire-int8" else 8
    calls = ops.kernel_calls["gba_apply_flat"]
    losses = train.main(["--arch", arch, "--reduced", "--steps", str(steps),
                         "--seq", "16", "--device", "cpu", *CLI[mode]])
    out = capsys.readouterr().out
    assert len(losses) == steps and np.isfinite(losses).all()
    applies = {"pytree": 0, "fused": 2, "fused-mesh": 8, "wire-int8": 16}
    assert ops.kernel_calls["gba_apply_flat"] - calls == applies[mode]
    if mode == "wire-int8":
        assert "quantized wire (int8): 4 workers x " in out
    else:
        assert "gstep 2" in out.strip().splitlines()[-1]


def test_lm_batch_carries_the_launchers_zero_memory():
    """``lm_batch``: the rows asked for, and zeros of the memory's shape
    in the model dtype, ``image_embeds`` for the VLM and ``frames`` for
    the audio model; none for a model without cross layers."""
    b = make_lm_stream(512, 8, 4, seed=0).batch(0)
    for arch, key, length in (("llama-3.2-vision-11b", "image_embeds", 16),
                              (AUDIO, "frames", 32)):
        cfg = get_config(arch).reduced()
        got = train.lm_batch(cfg, b, torch.device("cpu"), slice(1, 3))
        assert set(got) == {"tokens", "labels", key}
        assert torch.equal(got["tokens"], torch.from_numpy(b["tokens"][1:3]))
        assert got[key].shape == (2, length, cfg.d_model)
        assert got[key].dtype == torch.bfloat16 and not got[key].any()
    got = train.lm_batch(get_config("granite-8b").reduced(), b,
                         torch.device("cpu"))
    assert set(got) == {"tokens", "labels"} and got["tokens"].shape == (4, 8)


def test_autoswitch_cli_for_seamless_without_a_memory(capsys):
    """``--mesh 4x1 --autoswitch --batches 40``: the reference's
    ``batch_fn`` passes no memory, so the cross layers' ``xattn`` runs as
    a second self-attention; the swap between the pytree sync state and
    the flat async state is verified, and the losses are finite."""
    res = train.main(["--arch", AUDIO, "--reduced", "--mesh", "4x1",
                      "--seq", "16", "--device", "cpu", "--autoswitch",
                      "--batches", "40"])
    assert res.switch_count >= 1 and res.swaps_verified >= 1
    assert len(res.losses) >= 4 and np.isfinite(res.losses).all()
    assert "autoswitch (strained): " in capsys.readouterr().out


def test_fused_mesh_over_two_gloo_ranks(capfd):
    """``run_lm_fused`` over 2 shards on 2 gloo ranks (``--fused --mesh
    2x1 --ranks 2``) in float32: each rank takes half of each microstep's
    sequences and its rows of the zero memory, and prints the in-process
    run's losses to their 4 decimals (bf16 rounds each half-batch
    gradient before the sum: 1.0e-3 apart at the fourth microstep)."""
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b").reduced(),
                              dtype="float32")
    kw = dict(steps=4, batch=4, seq=16, buffer=2, workers=2)
    process_group.spawn(train.on_rank, 2, train.run_lm_fused, cfg, kw,
                        device="cpu", timeout=SPAWN_TIMEOUT)
    ranked = capfd.readouterr().out
    assert "process group: gloo, 2 ranks x 1 shards, 2 sequences" in ranked
    local = train.run_lm_fused(cfg, device="cpu", **kw)
    capfd.readouterr()
    steps = [line.split() for line in ranked.splitlines()
             if line.startswith("step ")]
    assert [(s[1], s[5]) for s in steps] == [("0", "0"), ("3", "2")]
    assert [s[3] for s in steps] == [f"{local[0]:.4f}", f"{local[3]:.4f}"]
