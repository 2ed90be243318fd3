"""The two architectures with ``cross`` layers on the CPU against the JAX
package: llama-3.2-vision-11b (a cross layer every 5th layer, over stub
image embeddings) and seamless-m4t-medium (a 12-layer audio encoder, then
12 cross layers over its output), at ``.reduced()`` (hd 64, G 1; 16
image tokens, or 32 frames through 2 encoder layers); the leaf spec at
full width.

Parameters come from one draw of the reference's ``init_model`` an arch
(float32), its zero-filled norm scales and biases then drawn at 0.1
N(0, 1) (at zeros a fault in their indexing would not show), shared
through a module fixture and carried to the port with
``convert.params_from_jax``; a bfloat16 run casts the same draw.  The
reference's functions run under ``jax.jit`` outside any mesh.  Memories
and frames are numpy draws handed to both.

Tolerances, with their reasons:
* float32: ``encode_audio``'s memory, the logits and every cache leaf
  within 1e-5 of their largest magnitude, greedy tokens equal (the two
  packages sum the same float32 products in other orders);
* bfloat16: logits and caches within 2**-6 of their largest, as
  ``tests/test_torch_archs_serve.py`` (XLA and PyTorch round bfloat16
  intermediates at different places);
* the cross decode's ``flash_decode`` route (its plain version on the
  CPU) against the masked route: within 1e-5 of the largest in float32,
  2**-6 in bfloat16 (the kernel's contract keeps its probabilities in
  float32 and its output in q's dtype, the masked route casts the
  probabilities to the value dtype and keeps a float32 output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.flat_sharded import path_names
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine

ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
AUDIO = "seamless-m4t-medium"
FULL_PARAMS = {"llama-3.2-vision-11b": 10_110_734_336,
               "seamless-m4t-medium": 977_821_696}
CPU = torch.device("cpu")
B, S, STEPS = 2, 24, 8
CACHE = S + STEPS + 1
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models run thousands of tiny operators: one intra-op
    thread keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _outside_any_mesh():
    """Run the reference outside any mesh, as the port runs; its
    module-global activation sharding is cleared for each test and
    restored after."""
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


@pytest.fixture(scope="module")
def draws():
    """One float32 draw of the reference's ``init_model`` an arch, as numpy
    arrays, the norms' zeros drawn at 0.1 N(0, 1)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, _ = _cfgs(arch)
        tree = jax.tree.map(np.asarray,
                            JT.init_model(jax.random.PRNGKey(i), jcfg))
        rng = np.random.default_rng(10 + i)

        def fill(path, x):
            if path_names(path)[-1] in ("scale", "bias"):
                return (x + 0.1 * rng.standard_normal(x.shape)).astype(
                    np.float32)
            return x
        out[arch] = jax.tree_util.tree_map_with_path(fill, tree)
    return out


def _model(draws, arch, dtype="float32"):
    """Both configs, the reference's parameters in ``dtype`` (the norms
    stay float32, as its ``init_norm`` makes them) and the port's from
    them."""
    jcfg, cfg = _cfgs(arch, dtype)
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    jp = jax.tree.map(lambda x, s: jnp.asarray(x, dtype=s.dtype),
                      draws[arch], shapes)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, cfg, jp, p


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_to_max(got, want, frac, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _cache_leaves(cache, jcache, frac, what):
    """Every array leaf of the reference's cache (``memory`` included)
    against the port's at the same path."""
    leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, want in leaves:
        node = cache
        for k in path:
            node = node[k.key]
        name = f"{what} {jax.tree_util.keystr(path)}"
        if want.ndim == 0 or want.dtype == jnp.int32:
            np.testing.assert_array_equal(node.numpy(), np.asarray(want))
        else:
            _close_to_max(node, want, frac, name)
    assert set(cache) == set(jcache)


def _memory(jp, jcfg, dtype, seed=3):
    """The memory both packages take: stub image embeddings, or stub frames
    through the reference's ``encode_audio``."""
    rows = jcfg.num_image_tokens or jcfg.encoder_frames
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, rows, jcfg.d_model)), dtype=_JDT[dtype])
    if jcfg.family == "audio":
        x = jax.jit(JT.encode_audio, static_argnums=1)(jp, jcfg, x)
    return x, torch.from_numpy(np.array(x, np.float32)).to(
        layers.dtype_of(jcfg))


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _launches_a_step(cfg) -> int:
    """``flash_decode`` calls a decode step at a scalar position: each
    global and cross layer's self-attention, and each cross layer's
    ``xattn`` (over the memory, or, without one, over the copy of the
    self-attention cache)."""
    kinds = cfg.block_pattern * cfg.num_repeats
    return sum(k == "global" for k in kinds) \
        + 2 * sum(k == "cross" for k in kinds)


# ---------------------------------------------------------------------------
# the configs and the leaf spec at full width
# ---------------------------------------------------------------------------

def _leaf_paths(tree, prefix=()):
    """(path, leaf) of a dict tree in ``jax.tree.flatten`` order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_spec_is_the_references_leaf_set(arch):
    """``model_spec`` at full width: the reference's paths, shapes and
    dtypes (``jax.eval_shape(init_model)``), the cross layers' ``lnx``
    and ``xattn``, seamless's stacked ``encoder`` and ``enc_norm``, and
    the parameter count."""
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
    assert n == FULL_PARAMS[arch]
    cross = f"l{len(cfg.block_pattern) - 1}"
    assert list(block[cross]) == ["ln1", "attn", "lnx", "xattn", "ln2", "mlp"]
    assert ("encoder" in top) == ("enc_norm" in top) == (arch == AUDIO)
    if arch == AUDIO:
        assert top["encoder"]["mlp"]["wo"].shape == (12, 4096, 1024)
        # the stacked leaf keeps one layer's scale, 1/sqrt(fan_in)
        assert top["encoder"]["mlp"]["wo"].scale == 4096 ** -0.5


# ---------------------------------------------------------------------------
# the encoder, prefill and decode
# ---------------------------------------------------------------------------

def test_encode_audio_matches_the_reference(draws):
    """float32: the memory from 32 frames through 2 causal RoPE'd encoder
    layers and ``enc_norm``."""
    jcfg, cfg, jp, p = _model(draws, AUDIO)
    frames = np.random.default_rng(4).standard_normal(
        (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    want = jax.jit(JT.encode_audio, static_argnums=1)(jp, jcfg,
                                                      jnp.asarray(frames))
    got = T.encode_audio(p, cfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_to_max(got, want, 1e-5, "encode_audio")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(draws, arch, dtype):
    """Prefill over the memory (its logits and every cache leaf,
    ``memory`` too), then 8 greedy decode steps at a scalar position
    (every self-attention and cross-attention through ``flash_decode``'s
    plain version), each with its logits, and the cache after; in
    float32 also 4 steps at a ragged (B,) vector of positions, whose
    cross-attention still takes the kernel's route."""
    jcfg, cfg, jp, p = _model(draws, arch, dtype)
    frac = TOL[dtype]
    jmem, mem = _memory(jp, jcfg, dtype)
    toks = _tokens(cfg.vocab_size, 5)
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(toks), jmem, CACHE)
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks), mem,
                              cache_len=CACHE)
    _close_to_max(logits, jl, frac, "prefill logits")
    _cache_leaves(cache, jc, frac, "prefill cache")
    assert cache["memory"] is mem
    empty = T.init_cache(cfg, B, CACHE, CPU, memory=mem)
    assert empty["memory"] is mem and int(empty["pos"]) == 0
    vec = {**T._map({k: v for k, v in cache.items() if k != "pos"},
                    torch.clone), "pos": torch.tensor([S, S - 5],
                                                      dtype=torch.int32)}
    jvec = {**jc, "pos": jnp.asarray([S, S - 5], jnp.int32)}
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    calls = ops.kernel_calls["flash_decode"]
    for step in range(STEPS):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits, jl, frac, f"decode {step}")
        if dtype == "float32":
            assert np.array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ops.kernel_calls["flash_decode"] == \
        calls + STEPS * _launches_a_step(cfg)
    assert int(cache["pos"]) == S + STEPS
    _cache_leaves(cache, jc, frac, "decode cache")
    if dtype == "bfloat16":
        return
    calls = ops.kernel_calls["flash_decode"]
    for step in range(4):
        jl, jvec = jdecode(jp, jcfg, jnp.asarray(tok), jvec)
        logits, vec = T.decode_step(p, cfg, torch.from_numpy(tok), vec)
        _close_to_max(logits, jl, frac, f"vector decode {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    cross = sum(k == "cross" for k in cfg.block_pattern) * cfg.num_repeats
    assert ops.kernel_calls["flash_decode"] == calls + 4 * cross
    _cache_leaves(vec, jvec, frac, "vector decode cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 1, 64, 16), (8, 2, 128, 40)],
                         ids=["hd64-G1", "hd128-G4"])
def test_cross_decode_kernel_route_matches_the_masked_route(
        shape, dtype, monkeypatch):
    """``attention_decode`` over a memory: the ``flash_decode`` route (the
    plain version on the CPU; one call) against the masked ``_sdpa``
    route (none), at seamless's reduced widths and at llama's head dim and
    group; neither reads ``pos`` nor writes the cache."""
    heads, kv, hd, length = shape
    cfg = dataclasses.replace(
        get_config("llama-3.2-vision-11b").reduced(), dtype=dtype,
        num_heads=heads, num_kv_heads=kv, head_dim=hd)
    gen = torch.Generator().manual_seed(6)
    p = T._materialize(layers.attention_spec(cfg), gen, CPU)
    dt = layers.dtype_of(cfg)
    x = torch.randn((3, 1, cfg.d_model), generator=gen).to(dt)
    memory = torch.randn((3, length, cfg.d_model), generator=gen).to(dt)
    cache = {"k": torch.zeros((3, 4, kv, hd), dtype=dt)}
    cache["v"] = cache["k"].clone()
    assert layers.cross_kernel(cfg)
    calls = ops.kernel_calls["flash_decode"]
    kern, out_cache = layers.attention_decode(p, cfg, x, cache,
                                              torch.tensor(2),
                                              kv_override=memory)
    assert ops.kernel_calls["flash_decode"] == calls + 1
    assert out_cache is cache and not cache["k"].any()
    monkeypatch.setattr(layers, "cross_kernel", lambda cfg: False)
    masked, _ = layers.attention_decode(p, cfg, x, cache,
                                        torch.tensor([0, 1, 2]),
                                        kv_override=memory)
    assert ops.kernel_calls["flash_decode"] == calls + 1
    assert kern.dtype == masked.dtype == dt and kern.shape == x.shape
    _close_to_max(kern, masked, TOL[dtype], "kernel vs masked route")


def test_cross_kernel_takes_the_kernels_shapes_only():
    """The route follows the shape: the kernel's head dims, at most 8
    query heads per KV head, no softcap."""
    cfg = get_config("llama-3.2-vision-11b")
    assert layers.cross_kernel(cfg)
    assert layers.cross_kernel(get_config(AUDIO))
    assert not layers.cross_kernel(dataclasses.replace(cfg, head_dim=96))
    assert not layers.cross_kernel(dataclasses.replace(cfg, num_kv_heads=2))
    assert not layers.cross_kernel(dataclasses.replace(cfg,
                                                       attn_softcap=50.0))


# ---------------------------------------------------------------------------
# without a memory: the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_memory_free_decode_matches_the_reference(draws, arch):
    """float32, no memory (as the reference's engine serves these archs):
    the prefill's ``xattn`` attends causally over the layer input and is
    not cached; each decode step's over the self-attention cache as it
    stood with its own row at ``pos``, the self-attention cache written
    once; 4 steps at a scalar position (both through ``flash_decode``'s
    plain version), then 4 at a ragged (B,) vector, with every cache
    leaf."""
    jcfg, cfg, jp, p = _model(draws, arch)
    toks = _tokens(cfg.vocab_size, 7)
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(toks), None, CACHE)
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks),
                              cache_len=CACHE)
    assert "memory" not in cache
    _close_to_max(logits, jl, 1e-5, "prefill logits")
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    calls = ops.kernel_calls["flash_decode"]
    for step in range(8):
        if step == 4:
            at = np.array([S + 4, S - 3], np.int32)
            cache["pos"], jc["pos"] = torch.from_numpy(at), jnp.asarray(at)
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits, jl, 1e-5, f"decode {step}")
        assert np.array_equal(logits.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        if step == 3:
            assert ops.kernel_calls["flash_decode"] == \
                calls + 4 * _launches_a_step(cfg)
            _cache_leaves(cache, jc, 1e-5, "scalar decode cache")
    _cache_leaves(cache, jc, 1e-5, "vector decode cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_references_engine(draws, arch):
    """float32: 3 requests in 2 slots through the port's engine and the
    reference's, both without a memory: equal stats, outputs and
    admission steps."""
    jcfg, cfg, jp, p = _model(draws, arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 5)]
    engine = ServingEngine(p, cfg, num_slots=2, max_len=24)
    ref = JaxServingEngine(jp, jcfg, num_slots=2, max_len=24)
    for i, prompt in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
        ref.submit(JaxRequest(uid=i, prompt=prompt, max_new_tokens=6))
    calls = ops.kernel_calls["flash_decode"]
    stats, ref_stats = engine.run(), ref.run()
    assert ops.kernel_calls["flash_decode"] == calls
    keys = ("completed", "decode_steps", "decode_tokens", "slot_utilization")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert stats["completed"] == 3
    for req, jreq in zip(engine.completed, ref.completed, strict=True):
        assert req.uid == jreq.uid and req.output == jreq.output
        assert req.admitted_at_step == jreq.admitted_at_step


# ---------------------------------------------------------------------------
# the launchers (training: tests/test_torch_archs_cross_train.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fixed_batch_and_engine_on_the_cpu(arch, capsys):
    """``launch.serve --reduced --device cpu``: the fixed-batch loop over
    the drawn memory (a flash_decode call a step for each self-attention
    and each cross-attention), then ``--engine`` (no memory, per-slot
    positions: none)."""
    calls = ops.kernel_calls["flash_decode"]
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen-len",
                      "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 2x12: ")
    assert lines[1].startswith("decode 3 steps: ")
    assert out["tokens"].shape == (2, 4)
    _, cfg = _cfgs(arch)
    assert ops.kernel_calls["flash_decode"] == \
        calls + 3 * _launches_a_step(cfg)
    calls = ops.kernel_calls["flash_decode"]
    stats = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--engine", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen-len", "4"])
    assert stats["completed"] == 3
    assert ops.kernel_calls["flash_decode"] == calls
    assert capsys.readouterr().out.startswith("engine: 3 completed in ")


@pytest.mark.parametrize("engine", [False, True], ids=["fixed", "engine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_default_device_raises_without_a_card(arch, engine):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced"]
                   + ["--engine"] * engine)
