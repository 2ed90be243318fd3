"""The model axis on the CPU: tensor parallelism over ``model`` on the
fused GBA step (``launch.train --arch A --fused --mesh WxT``), against the
JAX package.

* ``sharding.place`` and ``gather_model_shards`` round-trip a tree bit for
  bit, and carry the reference's draw over to model shards and back;
* ``model_axis`` takes every arch at full width and ``.reduced()`` for T
  in {2, 4, 8, 16}, naming the modules that split and the attention's
  design; a spec the rules cannot produce is refused;
* the T = 2 loss and its gradients against the reference's ``lm_loss``
  (or ``_loss_from_batch`` over a memory) and ``jax.grad``, the Mamba2
  archs and the rules' head_dim fallback included;
* the ``--fused --mesh 2x2`` step of the ten archs at ``.reduced()``
  float32, and three head_dim fallback meshes (starcoder2-3b at 2x4: the
  KV heads along head_dim; granite-8b and llama-3.2-vision-11b at 2x8:
  every projection along head_dim), 2 global steps at M = 4 with
  microstep 5's slot stale, against the reference's single-device
  ``build_programs(mode="fused")``, W x T ``gba_apply`` launches an
  apply.  The reference's own sharded step fails on jax 0.9 here (a
  ShardingTypeError in ``flat_buffer_push``, ROADMAP.md queue 3), and
  GSPMD's partitioning does not change the function, so its
  single-device step is the reference;
* in process against ranks, bit for bit: a gloo world of one rank, and
  one spawned world of 4 gloo ranks as a 2x2 grid (granite-8b and
  zamba2-2.7b), whose step with the model shards over the model subgroup
  equals its step with every model shard in process
  (``selfcheck.run_model_axis``);
* the launcher: ``--fused --mesh 2x2``, and the steps where the reference
  leaves ``model`` unused (the int8 and onebit wire, the switching
  harness and the pytree step at T = 2, ``--fused --mesh 1x2``), bit for
  bit the same runs at T = 1.

The reference runs outside any mesh with its module-global activation
sharding cleared (``_outside_any_mesh``), and its Pallas ``gba_apply`` as
its plain reference, as ``tests/test_torch_archs_fused.py`` runs them.
Tolerances are that file's: float32 losses within rtol 1e-6, flat params
and accumulator within rtol 1e-5 / atol 1e-7; gradients within 1e-5 of
each leaf's largest magnitude.  zamba2's flat state is held within rtol
1e-4 and its gradients within 5e-5, as ``tests/test_torch_archs_ssm.py``
holds its unsharded step: its reduced stack of 6 layers carries float32
rounding about ten times further than one layer (both packages' float32
gradients lie up to 1.8e-5 of their largest from a float64
evaluation).  The MoE archs' routes are held above ``MARGIN``, the least
gap between a token's K-th and (K+1)-th router probability, a hundred
times the float32 difference of the two packages' probabilities, so both
choose alike.
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
         "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "mamba2-780m",
         "zamba2-2.7b", "llama-3.2-vision-11b", "seamless-m4t-medium")
# where an arch's tolerance is not the others' (see above): the gradients
# (of each leaf's largest), the flat state (rtol)
GRAD_FRAC = {"zamba2-2.7b": 5e-5}
FLAT_RTOL = {"zamba2-2.7b": 1e-4}
B, S_LEN, M, IOTA, LR, SEED = 2, 80, 4, 4, 1e-3, 6
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]
MARGIN = 1e-4
MESH = Mesh(("data", "model"), (2, 2))
SPAWN_TIMEOUT = 240.0
_MODELS = {}


def _model(arch, **over):
    """Both ``.reduced()`` float32 configs (with the fields ``over``), the
    port's parameters from ``SEED`` and the same values as jax arrays; one
    draw a module."""
    key = (arch, *sorted(over.items()))
    if key not in _MODELS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **over)
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32", **over)
        _MODELS[key] = (jcfg, cfg, T.init_model(
            cfg, generator=torch.Generator().manual_seed(SEED),
            device="cpu"))
    jcfg, cfg, p = _MODELS[key]
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


def _carry_over(arch, mesh):
    """The JAX package's ``init_model`` draw of ``arch`` (bf16), as numpy
    arrays through ``convert.params_from_jax``, placed on the model shards
    of ``mesh`` (``tp.place``) by the port's specs, which are the
    reference's ``tuple(spec)``; put back together (``tp.gather_shards``),
    bit for bit the reference's."""
    from repro.distributed.sharding import param_specs as jax_param_specs
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    jcfg = jax_get_config(arch).reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp = model_axis(get_config(arch).reduced(), mesh, inprocess)
    jspecs = jax_param_specs(jp, jax.sharding.AbstractMesh(
        tuple(mesh.shape.values()), mesh.axis_names))
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(v) for _, v in flat[0]] == [s for _, s in
                                              tree_paths(tp.specs)]
    back = tp.gather_shards(tp.place(p))
    for (path, a), (_, b) in zip(tree_paths(back),
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16)), path
    return tp


def test_the_references_params_carry_over_to_model_shards_and_back():
    """kimi-k2 (its prefix list) over 2 model shards."""
    _carry_over("kimi-k2-1t-a32b", MESH)


@pytest.mark.parametrize("arch,t,design", [
    ("mamba2-780m", 2, (None, None)),
    ("zamba2-2.7b", 2, ("heads", "heads")),
    ("starcoder2-3b", 4, ("heads", "head_dim")),
    ("granite-8b", 8, ("head_dim", "head_dim")),
])
def test_the_references_params_carry_over_for_mamba_and_head_dim(arch, t,
                                                                  design):
    """The two Mamba2 archs over 2 model shards, and the rules' head_dim
    fallback: the KV heads (starcoder2-3b at 2x4), every projection
    (granite-8b at 2x8)."""
    tp = _carry_over(arch, Mesh(("data", "model"), (2, t)))
    assert tp.attn == design


# ---------------------------------------------------------------------------
# the splits the rules give, and a spec they cannot produce
# ---------------------------------------------------------------------------

def _want_split(cfg, t):
    """The module kinds the rules split of ``cfg`` at T = ``t``, and the
    attention's (q and wo, k and v) split."""
    kinds = set(cfg.block_pattern) | set(cfg.prefix_layers)
    want = {"vocab"} if cfg.vocab_size % t == 0 else set()
    if kinds & {"mamba", "mamba_attn"}:
        want.add("mamba")
    if kinds & {"moe", "local_moe"} and cfg.num_experts % t == 0:
        want.add("moe")
    if kinds - {"moe", "local_moe", "mamba"} - {"mamba_attn"} \
            and cfg.d_ff % t == 0:
        want.add("mlp")
    if kinds == {"mamba"}:
        return want, (None, None)
    want.add("attn")
    heads = "heads" if cfg.num_heads % t == 0 else "head_dim"
    kv = "heads" if cfg.num_kv_heads % t == 0 else "head_dim"
    return want, (heads, kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_takes_every_arch_at_every_t(arch):
    """Full width and ``.reduced()`` over W = 2 and T in {2, 4, 8, 16}:
    no refusal, the modules that split (a module whose dimension does not
    divide T whole: mamba2's 50,280-row vocabulary at 16, the reduced
    MoE's 4 experts at 8) and the attention's design (the rules' head_dim
    fallback where the (KV) heads do not divide T)."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        for t in (2, 4, 8, 16):
            tp = model_axis(cfg, Mesh(("data", "model"), (2, t)), inprocess)
            want, design = _want_split(cfg, t)
            assert (set(tp.split), tp.attn) == (want, design), (cfg.name, t)
            assert list(tp.held) == list(range(t))


def test_a_spec_the_rules_cannot_produce_is_refused(monkeypatch):
    """A split of a dimension the rules never cut (``wq``'s d_model,
    naming the leaf) and an attention whose k and v split otherwise than
    each other: a ``ValueError`` at build time."""
    cfg = get_config("granite-8b").reduced()
    specs = S.param_specs

    def bad(cut):
        def param_specs(shapes, mesh):
            out = specs(shapes, mesh)
            out["blocks"]["l0"]["attn"][cut[0]] = cut[1]
            return out
        return param_specs

    for cut, what in ((("wq", (None, "model", None, None)),
                       "leaf blocks/l0/attn/wq .*not a split of the rule"),
                      (("wv", (None, None, None, "model")),
                       "attention projections split")):
        monkeypatch.setattr(S, "param_specs", bad(cut))
        with pytest.raises(ValueError, match=what) as e:
            model_axis(cfg, MESH, inprocess)
        assert "ROADMAP.md" in str(e.value)


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


def _grads_match(arch, mesh, monkeypatch, **over):
    """The loss over the model shards of ``mesh``, and every leaf's
    gradient put back together from the shards (a whole leaf's once),
    against ``jax.grad`` of the reference's loss; MoE routes above
    ``MARGIN``."""
    jcfg, cfg, jp, p = _model(arch, **over)
    b = _batches(cfg, 1)[0]
    tp = model_axis(cfg, mesh, inprocess)
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
        _close_to_max(g.numpy(), want, GRAD_FRAC.get(arch, 1e-5),
                      "/".join(path))
    return tp


@pytest.mark.parametrize("arch", ["granite-8b", "phi3.5-moe-42b-a6.6b",
                                  "seamless-m4t-medium", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_t2_loss_and_gradients_match_jax_grad(arch, monkeypatch):
    """T = 2: a dense arch, an MoE arch (its routes above ``MARGIN``),
    the audio arch over its encoder, and the Mamba2 archs: the mixer
    gathered whole (mamba2's tied embedding vocab-parallel in the lookup
    and the head), zamba2's shared attention split by heads."""
    tp = _grads_match(arch, MESH, monkeypatch)
    assert ("mamba" in tp.split) == arch.startswith(("mamba", "zamba"))


@pytest.mark.parametrize("arch,t,over,design", [
    ("starcoder2-3b", 4, {}, ("heads", "head_dim")),
    ("starcoder2-3b", 4, {"head_dim": 18}, ("heads", None)),
    ("granite-8b", 8, {}, ("head_dim", "head_dim")),
    ("seamless-m4t-medium", 8, {}, ("head_dim", "head_dim")),
    ("zamba2-2.7b", 8, {}, ("head_dim", "head_dim")),
])
def test_head_dim_fallback_loss_and_gradients_match_jax_grad(
        arch, t, over, design, monkeypatch):
    """The rules' head_dim fallback: the KV heads along head_dim
    (starcoder2's 2 KV heads at T = 4), or whole where head_dim does not
    divide T either (head_dim 18); every projection along head_dim (4
    heads at T = 8: granite-8b, seamless' self-, cross- and encoder
    attention, zamba2's shared attention)."""
    tp = _grads_match(arch, Mesh(("data", "model"), (2, t)), monkeypatch,
                      **over)
    assert tp.attn == design


# ---------------------------------------------------------------------------
# the fused step over a 2x2 mesh and the head_dim fallback meshes
# ---------------------------------------------------------------------------

def _step_matches(arch, w, t, monkeypatch):
    """8 microsteps at M = 4, iota 4, microstep 5's token stale beyond
    iota, over the (``w``, ``t``) mesh; ``w * t`` ``gba_apply`` launches
    at microsteps 4 and 8 alone; the params and the accumulator put back
    together from the model shards against the reference's; the whole
    leaves' copies bit-identical."""
    jcfg, cfg, jp, p = _model(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                               params=jp, lr=LR)
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="fused",
                           lr=LR, workers=w, model=t, place_state=False)
    tp, lay = progs.model_axis, progs.layout
    assert progs.state["accum"].shape == (t * lay.padded_total,)
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
    assert applied == [0, 0, 0, w * t, 0, 0, 0, w * t]
    assert min(margins, default=1.0) > MARGIN
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    buf = ts["buffer"]
    assert (buf["fill"], buf["step"]) == (8, 2)
    np.testing.assert_array_equal(buf["tokens"].numpy(), [1, -5, 1, 1])
    params = tp.gather_shards(ts["params"])
    accum = tp.gather_shards([
        lay.unravel(ts["accum"][i * lay.padded_total:
                                (i + 1) * lay.padded_total], torch.float32)
        for i in range(t)])
    jflat = np.asarray(jprogs.layout.ravel(js["params"]))
    one = jprogs.layout
    flat = np.concatenate([x.reshape(-1).numpy()
                           for _, x in tree_paths(params)])
    jacc = np.asarray(js["accum"])
    acc = np.concatenate([x.reshape(-1).numpy()
                          for _, x in tree_paths(accum)])
    assert one.total == flat.size
    rtol = FLAT_RTOL.get(arch, 1e-5)
    np.testing.assert_allclose(flat, jflat, rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(acc, jacc, rtol=rtol, atol=1e-7)
    shards = [dict(tree_paths(s)) for s in ts["params"]]
    whole = [path for path, spec in tree_paths(tp.specs)
             if not S.model_dims(spec)]
    assert whole
    for path in whole:
        for other in shards[1:]:
            a, b = shards[0][path], other[path]
            assert a is not b and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32)), path
    return tp


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2x2_step_matches_the_references_fused_step(
        arch, monkeypatch, jax_apply_by_its_reference):
    """The ten archs over the 2x2 mesh."""
    _step_matches(arch, 2, 2, monkeypatch)


@pytest.mark.parametrize("arch,t,design", [
    ("starcoder2-3b", 4, ("heads", "head_dim")),
    ("granite-8b", 8, ("head_dim", "head_dim")),
    ("llama-3.2-vision-11b", 8, ("head_dim", "head_dim")),
])
def test_head_dim_fallback_step_matches_the_references_fused_step(
        arch, t, design, monkeypatch, jax_apply_by_its_reference):
    """The rules' head_dim fallback over a 2 x ``t`` mesh: starcoder2's 2
    KV heads at T = 4; every projection at T = 8 (4 heads), llama's
    cross-attention too."""
    assert _step_matches(arch, 2, t, monkeypatch).attn == design


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
                                   world=w, place_state=False)
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
    params and accumulator after 2 global steps; granite-8b, and
    zamba2-2.7b (the Mamba2 mixer gathered whole on each model rank, the
    shared attention split by heads) in the same world."""
    zamba = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                                dtype="float32")
    cases = [_granite(), (zamba, T.init_model(
        zamba, generator=torch.Generator().manual_seed(2), device="cpu"))]
    gba = GBAConfig(local_batch=B, buffer_size=2, staleness_tolerance=IOTA)
    assert process_group.grid(4, 2, 2) == 2
    with tempfile.TemporaryDirectory() as out:
        process_group.spawn(
            selfcheck.run_model_axis, 4, gba,
            [(cfg, p, _batches(cfg, 4)) for cfg, p in cases],
            [0, 0, 1, 1], 2, 2, out, device="cpu", timeout=SPAWN_TIMEOUT,
            model_ranks=2)
        saved = [torch.load(f"{out}/rank{r}.pt") for r in range(4)]
    for r, runs in enumerate(saved):
        assert len(runs) == len(cases)
        for (cfg, _), got in zip(cases, runs):
            ranks, here = got["ranks"], got["process"]
            assert torch.equal(ranks["losses"].view(torch.int32),
                               here["losses"].view(torch.int32)), cfg.name
            assert np.isfinite(ranks["losses"].numpy()).all()
            assert [k for k in ranks if k != "losses"] == [
                f"param/{r % 2}", f"accum/{r % 2}"]
            for k in ranks:
                assert torch.equal(ranks[k].view(torch.int32),
                                   here[k].view(torch.int32)), (cfg.name, r,
                                                                k)


# ---------------------------------------------------------------------------
# the launcher
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


def test_the_full_widths_split_at_t2_and_t4():
    """The ten archs at full width: every module splits at T = 2; at T =
    4 seamless' 256,206-row vocabulary stays whole (4 does not divide it)
    and starcoder2's 2 KV heads split along head_dim."""
    for arch in ARCHS:
        cfg = get_config(arch)
        tp = model_axis(cfg, Mesh(("data", "model"), (2, 2)), inprocess)
        kinds = set(cfg.block_pattern) | set(cfg.prefix_layers)
        mamba = kinds & {"mamba", "mamba_attn"}
        want = {"vocab"} | ({"moe"} if cfg.num_experts else set()) \
            | ({"mamba"} if mamba else set()) \
            | ({"attn"} if kinds - {"mamba"} else set()) \
            | ({"mlp"} if kinds - {"moe", "local_moe"} - mamba else set())
        assert tp.split == want, arch
    assert "vocab" not in model_axis(
        get_config("seamless-m4t-medium"),
        Mesh(("data", "model"), (2, 4)), inprocess).split
    assert model_axis(get_config("starcoder2-3b"),
                      Mesh(("data", "model"), (2, 4)),
                      inprocess).attn == ("heads", "head_dim")


@pytest.mark.parametrize("args,t1,says", [
    (["--fused", "--mesh", "4x2", "--compress", "int8", "--steps", "4"],
     ["--fused", "--mesh", "4x1", "--compress", "int8", "--steps", "4"],
     "model axis of 2 replicated: the wire step runs"),
    (["--fused", "--mesh", "4x2", "--compress", "onebit", "--steps", "4"],
     ["--fused", "--mesh", "4x1", "--compress", "onebit", "--steps", "4"],
     "model axis of 2 replicated: the wire step runs"),
    (["--mesh", "4x2", "--autoswitch", "--batches", "24"],
     ["--mesh", "4x1", "--autoswitch", "--batches", "24"],
     "model axis of 2 replicated: the switching harness"),
    (["--mesh", "2x2", "--steps", "4"], ["--mesh", "2x1", "--steps", "4"],
     "the pytree step runs unplaced, as without --mesh; the model axis of "
     "2 is replicated"),
    (["--fused", "--mesh", "1x2", "--steps", "4"], ["--fused", "--steps", "4"],
     "mesh data=1 x model=2: the single-layout fused step"),
])
def test_train_cli_steps_that_replicate_the_model_axis_equal_t1(
        args, t1, says, capsys):
    """Where the reference leaves ``model`` unused, the port runs the same
    step as at T = 1 and says so: the int8 and onebit wire and the
    switching harness over the data workers, the pytree step unplaced,
    the single-layout fused step at a data axis of 1; losses (and the
    switching summary) bit for bit the T = 1 run's."""
    base = ["--arch", "granite-8b", "--reduced", "--seq", "32", "--device",
            "cpu"]
    got = train.main(base + args)
    assert says in capsys.readouterr().out
    want = train.main(base + t1)
    if hasattr(got, "losses"):
        assert (got.mode_steps, got.switch_count) == (want.mode_steps,
                                                      want.switch_count)
        got, want = got.losses, want.losses
    assert len(got) == len(want) > 0
    assert np.array_equal(np.asarray(got, np.float64).view(np.int64),
                          np.asarray(want, np.float64).view(np.int64))


def test_other_modes_refuse_a_model_axis():
    """The wire and sync steps refuse a model axis, and so does the
    pytree step unplaced (``place_state=False``); placed, it is
    ``launch.steps.build_step``'s train step (``test_torch_steps.py``)."""
    cfg, p = _granite()
    for mode in ("pytree", "wire", "sync_psum"):
        kw = {"place_state": False} if mode == "pytree" else {}
        with pytest.raises(ValueError, match="replicates over model"):
            build_programs(cfg, GBAConfig(local_batch=B, buffer_size=M),
                           params=p, mode=mode, workers=2, model=2, **kw)
