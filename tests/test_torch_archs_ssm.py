"""The Mamba2 architectures of the port on the CPU against the JAX
package: mamba2-780m (tied embeddings) and zamba2-2.7b (the mixer with a
shared attention block) at ``.reduced()``, serving and training; the
leaf spec at full width.

Parameters are drawn by the port's ``init_model`` and carried to the
reference as jax arrays.  The leaves ``init_model`` fills (the norm
scales, ``A_log``, ``dt_bias``, ``D_skip``) are drawn from the seed as
well, at 0.1 N(0, 1) about their fills: at zeros and ones a fault in
their indexing would not show.  The
reference's functions run under ``jax.jit`` outside any mesh; its
fused step applies through ``gba_apply_ref`` (as in
``tests/test_torch_archs_fused.py``).

Tolerances, with their reasons:
* float32: logits and caches within 1e-5 of their largest magnitude, the
  loss within rtol 1e-5, greedy tokens equal; mamba2's gradient leaves
  within 1e-5 of their largest, and its steps as
  ``tests/test_torch_archs_train.py`` and
  ``tests/test_torch_archs_fused.py`` hold the other archs (pytree:
  losses rtol 1e-6, params atol lr / 4 with at most 1 in 1,000 beyond
  rtol 1e-5, optimizer state within 1e-3 of its largest; fused: losses
  rtol 1e-6, flat params and accumulator rtol 1e-5 / atol 1e-7).
  zamba2's reduced stack of 6 layers amplifies rounding about ten times
  more (its float32 logits agree to 7.5e-6 of the largest, gemma3-12b's
  to 7.5e-7): against a float64 evaluation of the same model both
  packages' float32 gradient leaves lie up to 1.8e-5 (the reference's)
  and 1.1e-5 (the port's) of their largest away, against about 1e-6 for
  mamba2's one layer.  So zamba2's gradients are held within 5e-5, its
  step losses within rtol 1e-5, its Adam moments within 5e-3 of their
  largest (1.0e-3 measured: the second global step's gradients are
  taken at params that Adam moved apart by a part of lr where a
  gradient is near its noise), its pytree params within 2 lr (two Adam
  steps) with at most 1 element in 10,000 beyond lr / 4 (2 of 274,432
  of a leaf measured, 1.1e-3 apart: Adam takes a step of about lr
  whatever the size of a gradient, so one within the noise of zero may
  step either way), at most 1 % of them beyond rtol 1e-4 / atol 1e-6
  (0.28 % measured: the second global step starts from the stepped
  params) and its fused flat params and
  accumulator within rtol 1e-4 / atol 1e-7 (the accumulator sums
  squared gradients: 4.4e-5 measured);
* bfloat16: mamba2-780m's logits within 2**-6 of the largest, as
  ``tests/test_torch_archs_serve.py``.  zamba2-2.7b's reduced stack is
  not held there: the reference's own bfloat16 logits lie 9.5 % of the
  largest from its float32 ones (the port's 6.6 %, the two bfloat16
  runs 12.6 % apart), so its bfloat16 forward is held by that distance:
  the port's bfloat16 logits no farther from the reference's float32
  ones than 1.5 times the reference's bfloat16 logits are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jax_ops
from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.core.flat_sharded import path_names
from repro.kernels.ref import gba_apply_ref as jax_gba_apply_ref
from repro.launch.programs import build_programs as jax_build_programs
from repro.models import transformer as JT
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.core.gba import FlatLayout, path_unflatten, tree_paths
from repro_torch.data import make_lm_stream
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.launch.programs import build_programs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import _slot_assign

ARCHS = ("mamba2-780m", "zamba2-2.7b")
ZAMBA = "zamba2-2.7b"
FULL_PARAMS = {"mamba2-780m": 779_989_248, "zamba2-2.7b": 2_343_761_568}
CPU = torch.device("cpu")
B, S, CACHE = 2, 40, 56
M, IOTA, LR = 4, 4, 1e-3
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]     # microstep 5 stale beyond iota
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# float32 tolerances an arch: gradient leaves and the pytree step's
# optimizer state (of their largest), step losses (rtol), fused flat
# params and accumulator (rtol; atol 1e-7), the share of the pytree
# step's params that may lie beyond lr / 4 (within 2 lr), and (rtol, atol,
# the share that may lie beyond them) of its params
F32 = {"mamba2-780m": {"grads": 1e-5, "state": 1e-3, "loss": 1e-6,
                       "flat": 1e-5, "stepped": 0.0,
                       "params": (1e-5, 1e-7, 1e-3)},
       "zamba2-2.7b": {"grads": 5e-5, "state": 5e-3, "loss": 1e-5,
                       "flat": 1e-4, "stepped": 1e-4,
                       "params": (1e-4, 1e-6, 1e-2)}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _outside_any_mesh():
    from repro.distributed import act_sharding
    saved = act_sharding._ACT_SHARDING, act_sharding._EXPERT_SHARDING
    act_sharding.set_act_spec(None)
    act_sharding.set_expert_spec(None)
    yield
    act_sharding.set_act_spec(saved[0])
    act_sharding.set_expert_spec(saved[1])


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of a dict tree in ``jax.tree.flatten`` order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _draw_fills(params, cfg, seed):
    """The filled leaves drawn: each its fill + 0.1 N(0, 1)."""
    top, block = T.model_spec(cfg)
    specs = [s for _, s in _leaf_paths({**top, "blocks": block})]
    gen = torch.Generator().manual_seed(seed + 100)
    for (path, t), spec in zip(tree_paths(params), specs, strict=True):
        if spec.scale is None:
            t.copy_(spec.fill + 0.1 * torch.randn(t.shape, generator=gen))
    return params


_MODELS = {}


def _model(arch, dtype="float32", seed=0):
    """Both configs, the port's parameters (the fills drawn) and the same
    values as the reference's; one draw a module, handed out as copies."""
    key = (arch, dtype, seed)
    if key not in _MODELS:
        jcfg, cfg = _cfgs(arch, dtype)
        p = T.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                         device=CPU)
        _MODELS[key] = (jcfg, cfg, _draw_fills(p, cfg, seed))
    jcfg, cfg, p = _MODELS[key]
    jp = jax.tree.map(
        lambda t: jnp.asarray(np.array(t.float().numpy()),
                              dtype=_JDT[t.dtype]), p)
    return jcfg, cfg, jp, T._map(p, torch.clone)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_to_max(got, want, frac, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _kernel_layers(cfg):
    return sum(k == "mamba_attn" for k in cfg.block_pattern) \
        * cfg.num_repeats


# ---------------------------------------------------------------------------
# the configs and the leaf spec at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_spec_is_the_references_leaf_set(arch):
    """``model_spec`` at full width: the reference's paths, shapes and
    dtypes (``jax.eval_shape(init_model)``), and its parameter count;
    mamba2 has no ``lm_head``, zamba2 one unstacked ``shared_attn``."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    T.check_supported(cfg)
    want = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jcfg))
    top, block = T.model_spec(cfg)
    got = {path: dataclasses.replace(spec, shape=(
        cfg.num_repeats, *spec.shape)) if path[0] == "blocks" else spec
        for path, spec in _leaf_paths({**top, "blocks": block})}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert list(got) == [path_names(k) for k, _ in flat]
    for k, w in flat:
        spec = got[path_names(k)]
        assert spec.shape == w.shape, k
        assert str(spec.dtype).removeprefix("torch.") == str(w.dtype), k
    n = sum(int(np.prod(s.shape)) for s in got.values())
    assert n == sum(int(np.prod(w.shape)) for _, w in flat) \
        == FULL_PARAMS[arch]
    assert ("lm_head" in top) == (arch == ZAMBA)
    assert ("shared_attn" in top) == (arch == ZAMBA)


def _split_from_fused(p, cfg):
    """The same weights in the split layout: ``in_proj``'s z, x, B, C and
    dt columns and ``conv_w``'s x, B and C columns as the split leaves."""
    d_inner, _, N = L.ssm_dims(cfg)
    cols = [d_inner, d_inner, N, N, p["in_proj"].shape[-1]
            - 2 * d_inner - 2 * N]
    out = {k: v for k, v in p.items() if k not in ("in_proj", "conv_w")}
    out |= dict(zip(("w_z", "w_x", "w_B", "w_C", "w_dt"),
                    torch.split(p["in_proj"], cols, dim=-1)))
    return out | dict(zip(("conv_x", "conv_B", "conv_C"),
                          torch.split(p["conv_w"], cols[1:4], dim=-1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_split_proj_variant_is_refused(arch):
    """``mamba_split_proj`` runs (it was refused before the port took
    it): the fused weights carried into the split layout give the fused
    model's logits, and its prefill then 4 decode steps (the three convs
    concatenated over the conv window) the fused model's, within 1e-5 of
    the largest (``tests/test_torch_variants.py`` holds the split layout
    against the reference's)."""
    _, cfg, _, p = _model(arch)
    split = dataclasses.replace(cfg, mamba_split_proj=True)
    T.check_supported(split)
    ps = {**p, "blocks": {
        k: {**v, "mixer": _split_from_fused(v["mixer"], cfg)}
        for k, v in p["blocks"].items()}}
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2))
    _close_to_max(T.forward(ps, split, toks), T.forward(p, cfg, toks), 1e-5,
                  "logits")
    want, cache = T.prefill(p, cfg, toks, cache_len=CACHE)
    got, scache = T.prefill(ps, split, toks, cache_len=CACHE)
    for step in range(5):
        _close_to_max(got, want, 1e-5, f"step {step}")
        tok = want.reshape(B, -1).argmax(-1)[:, None].to(torch.int32)
        want, cache = T.decode_step(p, cfg, tok, cache)
        got, scache = T.decode_step(ps, split, tok, scache)
    for name in ("ssm", "conv"):
        _close_to_max(scache["blocks"]["l0"]["ssm"][name],
                      cache["blocks"]["l0"]["ssm"][name], 1e-5, name)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_the_reference(arch):
    """float32: the logits, ``lm_loss`` and every leaf's gradient against
    ``jax.grad`` in the reference's flat order (the tied ``embed`` takes
    the lookup's and the head's, the ``shared_attn`` the sum over its
    layers)."""
    jcfg, cfg, jp, p = _model(arch)
    toks, labels = _tokens(cfg.vocab_size, 2), _tokens(cfg.vocab_size, 3)
    jlogits, _ = jax.jit(JT.forward, static_argnums=1)(jp, jcfg,
                                                       jnp.asarray(toks))
    _close_to_max(T.forward(p, cfg, torch.from_numpy(toks)), jlogits, 1e-5,
                  "logits")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda jp, t, y: JT.lm_loss(jp, jcfg, t, y)))(
        jp, jnp.asarray(toks), jnp.asarray(labels))
    paths, leaves = zip(*tree_paths(p))
    live = [x.detach().requires_grad_() for x in leaves]
    loss = T.lm_loss(path_unflatten(paths, live), cfg,
                     torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, live)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [path_names(k) for k, _ in flat] == list(paths)
    for path, g, (_, want) in zip(paths, grads, flat):
        _close_to_max(g, want, F32[arch]["grads"], "/".join(path))
    if arch == ZAMBA:
        assert ("shared_attn", "attn", "wq") in paths
    else:
        assert "lm_head" not in p


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward(arch):
    jcfg, cfg, jp, p = _model(arch, "bfloat16")
    toks = _tokens(cfg.vocab_size, 2)
    got = T.forward(p, cfg, torch.from_numpy(toks))
    jfwd = jax.jit(JT.forward, static_argnums=1)
    want = np.asarray(jfwd(jp, jcfg, jnp.asarray(toks))[0], np.float32)
    if arch != ZAMBA:
        _close_to_max(got, want, 2.0**-6, "bf16 logits")
        return
    j32 = dataclasses.replace(jcfg, dtype="float32")
    f32 = np.asarray(jfwd(jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        jp), j32, jnp.asarray(toks))[0], np.float32)
    ours, theirs = (np.abs(_np(x) - f32).max() for x in (got, want))
    assert ours <= 1.5 * theirs, (ours, theirs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _cache_leaves(cache, jcache, what):
    for path, want in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        node = cache
        for k in path:
            node = node[k.key]
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert tuple(node.shape) == want.shape, name
        assert str(node.dtype).removeprefix("torch.") == str(want.dtype), \
            name
        if want.ndim == 0:
            assert int(node) == int(want), name
        else:
            _close_to_max(node, want, 1e-5, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """float32: prefill (its logits and every cache leaf: states, conv
    windows, zamba2's k and v), 6 decode steps at a scalar position
    (zamba2's shared attention through ``flash_decode``'s plain version),
    then 6 at a ragged (B,) vector (the masked attention), each with its
    cache."""
    jcfg, cfg, jp, p = _model(arch)
    toks = _tokens(cfg.vocab_size, 4)
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(toks), None, CACHE)
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks),
                              cache_len=CACHE)
    _close_to_max(logits, jl, 1e-5, "prefill logits")
    _cache_leaves(cache, jc, "prefill cache")
    vec, jvec = _clone(cache), dict(jc)
    at = np.array([S, S - 5], np.int32)
    vec["pos"], jvec["pos"] = torch.from_numpy(at), jnp.asarray(at)
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    calls = ops.kernel_calls["flash_decode"]
    for step in range(6):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits, jl, 1e-5, f"scalar decode {step}")
        assert np.array_equal(logits.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ops.kernel_calls["flash_decode"] == calls + 6 * _kernel_layers(cfg)
    _cache_leaves(cache, jc, "scalar decode cache")
    tok = _tokens(cfg.vocab_size, 5, (B, 1))
    for step in range(6):
        jl, jvec = jdecode(jp, jcfg, jnp.asarray(tok), jvec)
        logits, vec = T.decode_step(p, cfg, torch.from_numpy(tok), vec)
        _close_to_max(logits, jl, 1e-5, f"vector decode {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ops.kernel_calls["flash_decode"] == calls + 6 * _kernel_layers(cfg)
    np.testing.assert_array_equal(vec["pos"].numpy(), at + 6)
    _cache_leaves(vec, jvec, "vector decode cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_the_forward(arch):
    """Prefill of S tokens, then 8 decode steps fed the next 8 tokens:
    each step's logits are the forward's over S + 8 tokens at that
    position.  A state or conv window not written back into the stacked
    cache would decode every step from the prefill's."""
    _, cfg, _, p = _model(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 6, (B, S + 8)))
    full = T.forward(p, cfg, toks)
    logits, cache = T.prefill(p, cfg, toks[:, :S], cache_len=S + 8)
    _close_to_max(logits, full[:, S - 1], 1e-5, "prefill")
    for i in range(S, S + 8):
        logits, cache = T.decode_step(p, cfg, toks[:, i:i + 1], cache)
        _close_to_max(logits[:, 0], full[:, i], 1e-5, f"decode at {i}")


def _offline_greedy(cfg, params, prompt, n_new):
    toks = torch.as_tensor(prompt, dtype=torch.int32)[None]
    logits, cache = T.prefill(params, cfg, toks,
                              cache_len=len(prompt) + n_new + 1)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, cache = T.decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                  cache)
        out.append(int(torch.argmax(lg[0, 0])))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_offline_greedy(arch):
    """float32: 5 requests of 4 to 30 tokens in 2 slots, each admission
    writing its states and conv windows into its slot's rows through
    ``_slot_assign``: every output equals the request's offline greedy
    decode."""
    _, cfg, _, p = _model(arch)
    rng = np.random.default_rng(7)
    engine = ServingEngine(p, cfg, num_slots=2, max_len=48)
    n_new = 10
    for uid, n in enumerate((30, 4, 17, 25, 9)):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=n_new))
    stats = engine.run()
    assert stats["completed"] == 5
    assert engine.cache["blocks"]["l0"]["ssm"]["ssm"].shape[1] == 2
    for req in engine.completed:
        assert req.output == _offline_greedy(cfg, p, req.prompt, n_new)


def test_slot_assign_writes_the_mixer_cache_into_one_slot():
    _, cfg = _cfgs(ZAMBA)
    full = T.init_cache(cfg, 3, 8, CPU)
    one = T.init_cache(cfg, 1, 8, CPU)
    for leaf in T._leaves({k: v for k, v in one.items() if k != "pos"}):
        leaf.fill_(1.0)
    _slot_assign(full, one, 1)
    for kind in ("l0", "l5"):
        for leaf in T._leaves(full["blocks"][kind]):
            assert bool((leaf[:, 1] == 1).all())
            assert not bool(leaf[:, [0, 2]].any())
    assert set(full["blocks"]["l5"]) == {"ssm", "attn"}
    assert full["blocks"]["l0"]["ssm"]["conv"].shape[:3] == (1, 3, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fixed_batch_and_engine_on_the_cpu(arch, capsys):
    calls = ops.kernel_calls["flash_decode"]
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen-len",
                      "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 2x20: ")
    assert lines[1].startswith("decode 5 steps: ")
    assert out["tokens"].shape == (2, 6)
    _, cfg = _cfgs(arch)
    assert ops.kernel_calls["flash_decode"] == \
        calls + 5 * _kernel_layers(cfg)
    stats = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--engine", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen-len", "4"])
    assert stats["completed"] == 3
    assert capsys.readouterr().out.startswith("engine: 3 completed in ")


# ---------------------------------------------------------------------------
# training: the pytree and fused steps
# ---------------------------------------------------------------------------

def _batches(cfg):
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    return [stream.batch(i) for i in range(len(TOKENS))]


@pytest.mark.parametrize("arch", ARCHS)
def test_pytree_step_matches_jax_over_8_microsteps(arch):
    """8 microsteps of ``build_programs(mode="pytree")`` with Adam at lr
    1e-3, M = 4, float32 accumulators, microstep 5 stale."""
    jcfg, cfg, jp, p = _model(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="pytree",
                               params=jp, optimizer=jax_get_optimizer(
                                   "adam", LR))
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="pytree",
                           optimizer=get_optimizer("adam", LR))
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for b, token in zip(_batches(cfg), TOKENS):
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=F32[arch]["loss"])
    assert (ts["micro"], ts["gstep"]) == (8, 2)
    assert int(ts["opt"]["count"]) == int(js["opt"]["count"]) == 2
    layout = FlatLayout.from_params(p)
    for what in ("acc", "m", "v"):
        jtree = js[what] if what == "acc" else js["opt"][what]
        ttree = ts[what] if what == "acc" else ts["opt"][what]
        for path, got, want in zip(layout.paths, layout.leaves(ttree),
                                   jax.tree.leaves(jtree)):
            _close_to_max(got, want, F32[arch]["state"], f"{what} {path}")
    beyond = stepped = 0
    for path, got, want in zip(layout.paths, layout.leaves(ts["params"]),
                               jax.tree.leaves(js["params"])):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR,
                                   err_msg="/".join(path))
        stepped += int((np.abs(got - want) > LR / 4).sum())
        rtol, atol, share = F32[arch]["params"]
        beyond += int((np.abs(got - want) > rtol * np.abs(want) + atol).sum())
    assert stepped <= F32[arch]["stepped"] * layout.total, stepped
    assert beyond <= share * layout.total, beyond


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_matches_jax_over_two_global_steps(arch, monkeypatch):
    """The fused step at M = 4 over 8 microsteps, one ``gba_apply`` at
    microsteps 4 and 8 alone; the reference's apply through its plain
    ``gba_apply_ref``."""
    def plain(p, a, buf, tokens, step, lr, *, iota, eps=1e-10,
              interpret=None):
        return jax_gba_apply_ref(p, a, buf, tokens, step, lr, iota=iota,
                                 eps=eps)
    monkeypatch.setattr(jax_ops, "gba_apply_flat", plain)
    jcfg, cfg, jp, p = _model(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                               params=jp, lr=LR)
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="fused",
                           lr=LR)
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
    assert applied == [0, 0, 0, 1, 0, 0, 0, 1]
    np.testing.assert_allclose(tl, jl, rtol=F32[arch]["loss"])
    assert progs.layout.paths == tuple(
        path_names(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(jp)[0])
    np.testing.assert_array_equal(ts["buffer"]["tokens"].numpy(),
                                  [1, -5, 1, 1])
    np.testing.assert_allclose(progs.layout.ravel(ts["params"]).numpy(),
                               np.asarray(jprogs.layout.ravel(js["params"])),
                               rtol=F32[arch]["flat"], atol=1e-7)
    np.testing.assert_allclose(ts["accum"].numpy(), np.asarray(js["accum"]),
                               rtol=F32[arch]["flat"], atol=1e-7)


def test_zamba_fused_step_over_2_shards_is_the_single_layout_step():
    """``--fused --mesh 2x1``: zamba2 over 2 layer-grouped shards (the
    ``shared_attn`` a group of its own) against one layout, from the same
    params and batches: losses, params and accumulator bit for bit, 2
    ``gba_apply`` launches an apply."""
    _, cfg, _, p = _model(ZAMBA)
    gba = GBAConfig(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    one = build_programs(cfg, gba, params=p, mode="fused", lr=LR)
    two = build_programs(cfg, gba, params=T._map(p, torch.clone),
                         mode="fused", lr=LR, workers=2, place_state=False)
    lay = two.layout
    assert lay.num_shards == 2
    assert lay.group_keys == ("blocks.l0", "blocks.l1", "blocks.l2",
                              "blocks.l3", "blocks.l4", "blocks.l5",
                              "embed", "final_norm", "head", "shared_attn")
    s1, s2 = one.state, two.state
    for i, (b, token) in enumerate(zip(_batches(cfg), TOKENS)):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        s1, l1 = one.step(s1, batch, token)
        calls = ops.kernel_calls["gba_apply_flat"]
        s2, l2 = two.step(s2, batch, token)
        assert ops.kernel_calls["gba_apply_flat"] - calls == (
            2 if (i + 1) % M == 0 else 0)
        assert torch.equal(l1.view(torch.int32), l2.view(torch.int32))
    for a, b in zip(one.layout.leaves(s1["params"]),
                    lay.leaves(s2["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    accum = lay.unravel(s2["accum"], torch.float32)
    for a, b in zip(one.layout.leaves(one.layout.unravel(s1["accum"])),
                    lay.leaves(accum)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("fused", [False, True], ids=["pytree", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_the_cpu(arch, fused, capsys):
    calls = ops.kernel_calls["gba_apply_flat"]
    losses = train.main(["--arch", arch, "--reduced", "--steps", "8",
                         "--seq", "32", "--device", "cpu"]
                        + (["--fused"] if fused else []))
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert ops.kernel_calls["gba_apply_flat"] - calls == (2 if fused else 0)
    assert ("fused gba_apply path (Adagrad): flat buffer (4, " if fused
            else "pytree GBA path (adam): M=4, iota=4") in out
    assert "gstep 2" in out.strip().splitlines()[-1]
