"""The model axis on the CPU: tensor parallelism over ``model`` on the
fused GBA step (``launch.train --arch A --fused --mesh WxT``), against the
JAX package.

* ``sharding.place`` and ``gather_model_shards`` round-trip a tree bit for
  bit;
* the T = 2 loss and its gradients against the reference's ``lm_loss``
  (or ``_loss_from_batch`` over a memory) and ``jax.grad``;
* the ``--fused --mesh 2x2`` step of the eight archs without Mamba layers
  at ``.reduced()`` float32, 2 global steps at M = 4 with microstep 5's
  slot stale, against the reference's single-device
  ``build_programs(mode="fused")``, 4 ``gba_apply`` launches an apply.
  The reference's own 2x2 sharded step fails on jax 0.9 here (a
  ShardingTypeError in ``flat_buffer_push``, ROADMAP.md queue 3), and
  GSPMD's partitioning does not change the function, so its
  single-device step is the reference;
* in process against ranks, bit for bit: a gloo world of one rank, and
  one spawned world of 4 gloo ranks as a 2x2 grid, whose step with the
  model shards over the model subgroup equals its step with every model
  shard in process (``selfcheck.run_model_axis``);
* the refusals: a Mamba arch over T > 1, the head_dim fallback, KV heads
  that do not divide T, and the launcher's ``--compress`` and
  ``--autoswitch`` at T > 1.

The reference runs outside any mesh with its module-global activation
sharding cleared (``_outside_any_mesh``), and its Pallas ``gba_apply`` as
its plain reference, as ``tests/test_torch_archs_fused.py`` runs them.
Tolerances are that file's: float32 losses within rtol 1e-6, flat params
and accumulator within rtol 1e-5 / atol 1e-7; gradients within 1e-5 of
each leaf's largest magnitude.  The MoE archs' routes are held above
``MARGIN``, the least gap between a token's K-th and (K+1)-th router
probability, a hundred times the float32 difference of the two packages'
probabilities, so both choose alike.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.core.flat_sharded import path_names
from repro.launch.programs import _loss_from_batch as jax_loss_from_batch
from repro.launch.programs import build_programs as jax_build_programs
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.core.gba import path_unflatten, tree_paths
from repro_torch.data import make_lm_stream
from repro_torch.distributed import inprocess, process_group, selfcheck
from repro_torch.distributed import sharding as S
from repro_torch.distributed.tensor_parallel import model_axis
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.programs import _loss_from_batch, build_programs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_archs_fused import jax_apply_by_its_reference  # noqa: F401
from test_torch_archs_train import (  # noqa: F401 (fixtures)
    _close_to_max, _outside_any_mesh, one_torch_thread)

ARCHS = ("granite-8b", "gemma2-27b", "gemma3-12b", "starcoder2-3b",
         "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
         "seamless-m4t-medium")
B, S_LEN, M, IOTA, LR, SEED = 2, 80, 4, 4, 1e-3, 6
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]
MARGIN = 1e-4
MESH = Mesh(("data", "model"), (2, 2))
SPAWN_TIMEOUT = 240.0
_MODELS = {}


def _model(arch):
    """Both ``.reduced()`` float32 configs, the port's parameters from
    ``SEED`` and the same values as jax arrays; one draw a module."""
    if arch not in _MODELS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32")
        _MODELS[arch] = (jcfg, cfg, T.init_model(
            cfg, generator=torch.Generator().manual_seed(SEED),
            device="cpu"))
    jcfg, cfg, p = _MODELS[arch]
    return jcfg, cfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), \
        T._map(p, torch.clone)


def _batches(cfg, n=len(TOKENS), rows=B):
    """The LM stream's batches (seed 0), with a drawn memory for the cross
    archs, as numpy."""
    stream = make_lm_stream(cfg.vocab_size, S_LEN, rows, seed=0)
    out = []
    for i in range(n):
        b = dict(stream.batch(i))
        if cfg.family in ("vlm", "audio"):
            key = "image_embeds" if cfg.family == "vlm" else "frames"
            length = cfg.num_image_tokens or cfg.encoder_frames
            b[key] = np.random.default_rng(50 + i).standard_normal(
                (rows, length, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _margins(monkeypatch) -> list:
    """The least gap between a token's K-th and (K+1)-th router
    probability of every route the port takes."""
    seen, route = [], L.moe_route

    def spy(p, cfg, xt, logits=None):
        r = route(p, cfg, xt, logits)
        probs = torch.softmax(xt.float() @ p["router"] if logits is None
                              else logits, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.experts_per_token
        seen.append((top[:, k - 1] - top[:, k]).min().item())
        return r

    monkeypatch.setattr(L, "moe_route", spy)
    return seen


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_place_and_gather_round_trip_bit_for_bit(arch, t):
    """Each shard's split leaves are its contiguous slices, its whole
    leaves the tensors themselves; the shards put back together are the
    tree, bit for bit (bfloat16 weights)."""
    cfg = get_config(arch).reduced()
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    mesh = Mesh(("data", "model"), (1, t))
    specs = S.param_specs(p, mesh)
    shards = [S.place(p, specs, mesh, i) for i in range(t)]
    back = S.gather_model_shards(shards, specs, mesh)
    split = 0
    for (path, a), (_, b), (_, s0) in zip(tree_paths(p), tree_paths(back),
                                          tree_paths(shards[0])):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16)), path
        dims = S.model_dims(S._leaf_spec(path, tuple(a.shape), mesh))
        if dims:
            split += 1
            assert s0.shape[dims[0]] * t == a.shape[dims[0]]
            assert s0.is_contiguous() and s0.data_ptr() != a.data_ptr()
        else:
            assert s0 is a, path
    assert split > 0
    with pytest.raises(IndexError):
        S.place(p, specs, mesh, t)


def test_the_references_params_carry_over_to_model_shards_and_back():
    """The JAX package's ``init_model`` draw of kimi-k2 (bf16, its prefix
    list), as numpy arrays through ``convert.params_from_jax``, placed on
    2 model shards by the port's specs, which are the reference's
    ``tuple(spec)``; put back together, bit for bit the reference's."""
    from repro.distributed.sharding import param_specs as jax_param_specs
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    jcfg = jax_get_config("kimi-k2-1t-a32b").reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    specs = S.param_specs(p, MESH)
    jspecs = jax_param_specs(jp, jax.sharding.AbstractMesh(
        (2, 2), ("data", "model")))
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(v) for _, v in flat[0]] == [s for _, s in
                                              tree_paths(specs)]
    back = S.gather_model_shards([S.place(p, specs, MESH, t)
                                  for t in range(2)], specs, MESH)
    for (path, a), (_, b) in zip(tree_paths(back),
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16)), path


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def _live_shards(tp, p):
    """The held shards' trees with live leaves: a split leaf's own on each
    shard, a whole leaf's one tensor on all; and the unique live tensors
    in order."""
    paths = [path for path, _ in tree_paths(p)]
    live, seen, trees = [], {}, []
    for s in tp.place(p):
        leaves = []
        for _, x in tree_paths(s):
            if id(x) not in seen:
                seen[id(x)] = x.detach().requires_grad_()
                live.append(seen[id(x)])
            leaves.append(seen[id(x)])
        trees.append(path_unflatten(paths, leaves))
    return trees, live


@pytest.mark.parametrize("arch", ["granite-8b", "phi3.5-moe-42b-a6.6b",
                                  "seamless-m4t-medium"])
def test_t2_loss_and_gradients_match_jax_grad(arch, monkeypatch):
    """The loss over T = 2 model shards, and every leaf's gradient put
    back together from the shards (a whole leaf's once), against
    ``jax.grad`` of the reference's loss: a dense arch, an MoE arch (its
    routes above ``MARGIN``) and the audio arch over its encoder."""
    jcfg, cfg, jp, p = _model(arch)
    b = _batches(cfg, 1)[0]
    tp = model_axis(cfg, MESH, inprocess)
    margins = _margins(monkeypatch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda jp, b: jax_loss_from_batch(jp, jcfg, b)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    trees, live = _live_shards(tp, p)
    loss = _loss_from_batch(trees, cfg, {k: torch.from_numpy(v)
                                         for k, v in b.items()}, tp)
    got = dict(zip(map(id, live), torch.autograd.grad(loss, live)))
    assert min(margins, default=1.0) > MARGIN
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    gtrees = [T._map(t, lambda x: got[id(x)]) for t in trees]
    grads = tp.gather_shards(gtrees)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [path for path, _ in tree_paths(grads)]
    assert [path_names(k) for k, _ in flat] == paths
    for (path, g), (_, want) in zip(tree_paths(grads), flat):
        _close_to_max(g.numpy(), want, 1e-5, "/".join(path))


# ---------------------------------------------------------------------------
# the fused step over a 2x2 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2x2_step_matches_the_references_fused_step(
        arch, monkeypatch, jax_apply_by_its_reference):
    """8 microsteps at M = 4, iota 4, microstep 5's token stale beyond
    iota; 4 ``gba_apply`` launches at microsteps 4 and 8 alone; the params
    and the accumulator put back together from the model shards against
    the reference's; the whole leaves' copies bit-identical."""
    jcfg, cfg, jp, p = _model(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                               params=jp, lr=LR)
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="fused",
                           lr=LR, workers=2, model=2)
    tp, lay = progs.model_axis, progs.layout
    assert progs.state["accum"].shape == (2 * lay.padded_total,)
    margins = _margins(monkeypatch)
    js, ts, jl, tl, applied = jprogs.state, progs.state, [], [], []
    for b, token in zip(_batches(cfg), TOKENS):
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        calls = ops.kernel_calls["gba_apply_flat"]
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
        applied.append(ops.kernel_calls["gba_apply_flat"] - calls)
    assert applied == [0, 0, 0, 4, 0, 0, 0, 4]
    assert min(margins, default=1.0) > MARGIN
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    buf = ts["buffer"]
    assert (buf["fill"], buf["step"]) == (8, 2)
    np.testing.assert_array_equal(buf["tokens"].numpy(), [1, -5, 1, 1])
    params = tp.gather_shards(ts["params"])
    accum = tp.gather_shards([
        lay.unravel(ts["accum"][i * lay.padded_total:
                                (i + 1) * lay.padded_total], torch.float32)
        for i in range(2)])
    jflat = np.asarray(jprogs.layout.ravel(js["params"]))
    one = jprogs.layout
    flat = np.concatenate([x.reshape(-1).numpy()
                           for _, x in tree_paths(params)])
    jacc = np.asarray(js["accum"])
    acc = np.concatenate([x.reshape(-1).numpy()
                          for _, x in tree_paths(accum)])
    assert one.total == flat.size
    np.testing.assert_allclose(flat, jflat, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(acc, jacc, rtol=1e-5, atol=1e-7)
    whole = 0
    for (path, a), (_, b), (_, spec) in zip(tree_paths(ts["params"][0]),
                                            tree_paths(ts["params"][1]),
                                            tree_paths(tp.specs)):
        if not S.model_dims(spec):
            whole += 1
            assert a is not b and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32)), path
    assert whole > 0


# ---------------------------------------------------------------------------
# in process against ranks
# ---------------------------------------------------------------------------

def _granite():
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    return cfg, T.init_model(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")


def test_one_rank_world_is_the_in_process_step_bit_for_bit(tmp_path):
    """``--fused --mesh 2x2`` over a gloo world of one rank (both model
    shards, both data shards, the whole batch: the card's NCCL world) is
    the in-process step bit for bit over 4 microsteps at M = 2."""
    cfg, p = _granite()
    gba = GBAConfig(local_batch=B, buffer_size=2, staleness_tolerance=IOTA)
    batches = _batches(cfg, 4)
    threads = torch.get_num_threads()
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cpu", timeout=60.0, threads=threads)
    try:
        runs = []
        for w in (world, inprocess):
            progs = build_programs(cfg, gba, params=T._map(p, torch.clone),
                                   mode="fused", lr=LR, workers=2, model=2,
                                   world=w)
            st, losses = progs.state, []
            for i, b in enumerate(batches):
                st, loss = progs.step(st, {k: torch.from_numpy(v)
                                           for k, v in b.items()}, i // 2)
                losses.append(loss)
            runs.append((progs.layout, st, torch.stack(losses)))
    finally:
        process_group.leave()
        torch.set_num_threads(threads)
    (lay, got, gl), (_, want, wl) = runs
    assert torch.equal(gl.view(torch.int32), wl.view(torch.int32))
    assert torch.equal(got["accum"].view(torch.int32),
                       want["accum"].view(torch.int32))
    for a, b in zip(got["params"], want["params"]):
        assert torch.equal(lay.ravel(a).view(torch.int32),
                           lay.ravel(b).view(torch.int32))


def test_four_gloo_ranks_as_a_2x2_grid_give_the_in_process_bits():
    """4 gloo ranks, ``process_group.grid(4, 2, 2)`` = 2 model ranks: each
    rank holds one model shard and one data shard and takes its data
    coordinate's rows.  Its step (the model collectives over the model
    subgroup) equals, bit for bit, the step with both model shards in
    process over the same data subgroup: losses, every model shard's
    params and accumulator after 2 global steps."""
    cfg, p = _granite()
    gba = GBAConfig(local_batch=B, buffer_size=2, staleness_tolerance=IOTA)
    assert process_group.grid(4, 2, 2) == 2
    with tempfile.TemporaryDirectory() as out:
        process_group.spawn(
            selfcheck.run_model_axis, 4, cfg, gba, p, _batches(cfg, 4),
            [0, 0, 1, 1], 2, 2, out, device="cpu", timeout=SPAWN_TIMEOUT,
            model_ranks=2)
        saved = [torch.load(f"{out}/rank{r}.pt") for r in range(4)]
    for r, got in enumerate(saved):
        ranks, here = got["ranks"], got["process"]
        assert torch.equal(ranks["losses"].view(torch.int32),
                           here["losses"].view(torch.int32))
        assert np.isfinite(ranks["losses"].numpy()).all()
        assert [k for k in ranks if k != "losses"] == [
            f"param/{r % 2}", f"accum/{r % 2}"]
        for k in ranks:
            assert torch.equal(ranks[k].view(torch.int32),
                               here[k].view(torch.int32)), (r, k)


# ---------------------------------------------------------------------------
# the launcher and the refusals
# ---------------------------------------------------------------------------

def test_train_cli_mesh_2x2_runs_on_the_cpu(capsys):
    """``launch.train --arch granite-8b --fused --mesh 2x2 --reduced
    --device cpu``: 8 finite losses, 4 ``gba_apply`` launches at each of
    the two global steps, and the mesh line."""
    calls = ops.kernel_calls["gba_apply_flat"]
    losses = train.main(["--arch", "granite-8b", "--reduced", "--fused",
                         "--mesh", "2x2", "--steps", "8", "--seq", "32",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert ops.kernel_calls["gba_apply_flat"] - calls == 8
    assert "model axis: mesh data=2 x model=2, model shards [0, 1]" in out
    assert "4 gba_apply launches an apply" in out
    assert "gstep 2" in out.strip().splitlines()[-1]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_a_mamba_arch_refuses_a_model_axis(arch, capsys):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model_axis(cfg, MESH, inprocess)
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_programs(cfg, GBAConfig(local_batch=B, buffer_size=M),
                       params=p, mode="fused", workers=2, model=2)
    with pytest.raises(SystemExit):
        train.main(["--arch", arch, "--reduced", "--fused", "--mesh", "2x2",
                    "--device", "cpu"])
    assert "ROADMAP.md" in capsys.readouterr().err


@pytest.mark.parametrize("arch,t,what", [
    ("starcoder2-3b", 4, "head_dim fallback"),       # reduced: 2 KV heads
    ("granite-8b", 16, "head_dim fallback"),         # full: 8 KV heads
    ("starcoder2-3b", 16, "head_dim fallback"),      # full: 24 heads
])
def test_a_split_that_needs_the_head_dim_fallback_is_refused(arch, t, what):
    """At build time, naming the leaf and ROADMAP.md: the rules split
    head_dim where the (KV) heads do not divide T."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if t == 4 else cfg
    with pytest.raises(ValueError, match=what) as e:
        model_axis(cfg, Mesh(("data", "model"), (1, t)), inprocess)
    assert "ROADMAP.md" in str(e.value) and "/w" in str(e.value)


def test_the_full_widths_split_at_t2_and_t4():
    """The eight archs at full width: every module splits at T = 2, and at
    T = 4 seamless' 256,206-row vocabulary stays whole (4 does not divide
    it) while starcoder2's 2 KV heads are refused."""
    for arch in ARCHS:
        cfg = get_config(arch)
        tp = model_axis(cfg, Mesh(("data", "model"), (2, 2)), inprocess)
        kinds = set(cfg.block_pattern) | set(cfg.prefix_layers)
        want = {"attn", "vocab"} | ({"moe"} if cfg.num_experts else set()) \
            | ({"mlp"} if kinds - {"moe", "local_moe"} else set())
        assert tp.split == want, arch
    assert "vocab" not in model_axis(
        get_config("seamless-m4t-medium"),
        Mesh(("data", "model"), (2, 4)), inprocess).split
    with pytest.raises(ValueError, match="ROADMAP.md"):
        model_axis(get_config("starcoder2-3b"),
                   Mesh(("data", "model"), (2, 4)), inprocess)


@pytest.mark.parametrize("extra", [
    ["--compress", "int8"], ["--compress", "onebit"], ["--autoswitch"]])
def test_train_cli_refuses_t_above_1_for_the_wire_and_autoswitch(extra,
                                                                 capsys):
    args = ["--arch", "granite-8b", "--reduced", "--mesh", "2x2",
            "--device", "cpu", "--steps", "2"]
    if extra[0] != "--autoswitch":
        args.append("--fused")
    with pytest.raises(SystemExit):
        train.main(args + extra)
    assert "replicates over model" in capsys.readouterr().err


def test_other_modes_refuse_a_model_axis():
    cfg, p = _granite()
    for mode in ("pytree", "wire", "sync_psum"):
        with pytest.raises(ValueError, match="replicates over model"):
            build_programs(cfg, GBAConfig(local_batch=B, buffer_size=M),
                           params=p, mode=mode, workers=2, model=2)
