"""Serving the attention-family architectures of the port on the CPU
against the JAX package, at ``.reduced()``: prefill (its logits and every
leaf of its cache: the sliding window's rings, kimi-k2's prefix list),
then 6 decode steps at a scalar position (``flash_decode``'s plain
version on each global layer without a softcap, the masked attention on
the rest) and 6 at a (B,) vector of ragged positions (the masked
attention everywhere), with prompts past the reduced window of 64 so that
every ring wraps; the continuous-batching engine on gemma3-12b's rings;
``_slot_assign`` on kimi-k2's prefix cache; and ``launch.serve`` for the
five.

Parameters are drawn by the port's ``init_model`` (cheaper than compiling
the reference's) and carried to the reference as jax arrays; the
reference's model functions run under ``jax.jit`` outside any mesh.  Tolerances, as
``tests/test_torch_serve_lm.py`` states its own: float32 logits within
1e-5 of their largest magnitude and greedy tokens equal, caches within
1e-5 of their largest; bfloat16 logits and caches within 2**-6 of their
largest (XLA and PyTorch round bfloat16 intermediates at different
places).  The MoE's expert choices at the parameter seed (1) have no
near-tie in either dtype: in bfloat16 a choice within the packages'
roundings of a tie flips and moves the logits past the tolerance, as it
does at 2 of the seeds 1 to 15 (``tests/test_torch_archs.py`` holds the
choices exactly).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import _slot_assign

ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
         "kimi-k2-1t-a32b")
CPU = torch.device("cpu")
B, S, CACHE = 2, 80, 96
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}


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


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _params(cfg, seed=1):
    """The port's parameters and the same values as the reference's."""
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                     device=CPU)
    return jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), dtype=_JDT[t.dtype]), p), p


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_to_max(got, want, frac, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _kernel_layers(cfg) -> int:
    """Layers whose scalar-position decode runs ``flash_decode``: global
    ones, in a model without an attention softcap."""
    if cfg.attn_softcap:
        return 0
    kinds = (*cfg.prefix_layers, *cfg.block_pattern * cfg.num_repeats)
    return sum(k in ("global", "moe") for k in kinds)


def _cache_leaves(cache, jcache, frac, what):
    """Every array leaf of the reference's cache against the port's at the
    same path (prefix lists included)."""
    leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert leaves
    for path, want in leaves:
        node = cache
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert tuple(node.shape) == want.shape, name
        if want.ndim == 0 or want.dtype == jnp.int32:
            np.testing.assert_array_equal(node.numpy(), np.asarray(want))
        else:
            _close_to_max(node, want, frac, name)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    jp, p = _params(cfg)
    frac = TOL[dtype]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    jprefill = jax.jit(JT.prefill, static_argnums=(1, 4))
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    jl, jc = jprefill(jp, jcfg, jnp.asarray(toks), None, CACHE)
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks), cache_len=CACHE)
    _close_to_max(logits, jl, frac, "prefill logits")
    _cache_leaves(cache, jc, frac, "prefill cache")
    if cfg.sliding_window:
        ring = cache["blocks"]["l0"]["attn"]["k"]
        assert ring.shape[2] == cfg.sliding_window < S     # it wrapped
    if cfg.prefix_layers:
        assert len(cache["prefix"]) == len(cfg.prefix_layers)
    # (B,) ragged positions from a copy of the prefill's cache
    vec, jvec = _clone(cache), dict(jc)
    at = np.array([S, S - 5], np.int32)
    vec["pos"], jvec["pos"] = torch.from_numpy(at), jnp.asarray(at)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    calls = ops.kernel_calls["flash_decode"]
    for step in range(6):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits, jl, frac, f"scalar decode {step}")
        assert int(cache["pos"]) == int(jc["pos"]) == S + 1 + step
        if dtype == "float32":
            assert np.array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ops.kernel_calls["flash_decode"] == calls + 6 * _kernel_layers(cfg)
    _cache_leaves(cache, jc, frac, "scalar decode cache")
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 1)) \
        .astype(np.int32)
    for step in range(6):
        jl, jvec = jdecode(jp, jcfg, jnp.asarray(tok), jvec)
        logits, vec = T.decode_step(p, cfg, torch.from_numpy(tok), vec)
        _close_to_max(logits, jl, frac, f"vector decode {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ops.kernel_calls["flash_decode"] == calls + 6 * _kernel_layers(cfg)
    np.testing.assert_array_equal(vec["pos"].numpy(), at + 6)
    _cache_leaves(vec, jvec, frac, "vector decode cache")


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


def test_engine_on_gemma3_rings_matches_offline_greedy():
    """gemma3-12b.reduced() in float32: 5 requests in 2 slots whose
    prompts and outputs run past the window of 64, so each slot's rings
    wrap at its own position; every output equals the offline greedy
    decode of its request alone (a scalar position, flash_decode's plain
    version on the global layer)."""
    _, cfg = _cfgs("gemma3-12b")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    rng = np.random.default_rng(4)
    engine = ServingEngine(params, cfg, num_slots=2, max_len=96)
    n_new = 12
    for uid, n in enumerate((70, 30, 60, 64, 75)):
        engine.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=n_new))
    stats = engine.run()
    assert stats["completed"] == 5 and stats["clamped_requests"] == 0
    assert engine.cache["blocks"]["l0"]["attn"]["k"].shape[2] == 64
    for req in engine.completed:
        assert req.output == _offline_greedy(cfg, params, req.prompt, n_new)


def test_slot_assign_keeps_kimi_prefix_cache():
    """kimi-k2's cache has a ``prefix`` list beside its stacked blocks:
    ``_slot_assign`` writes a request's prefix and block rows into its
    slot alone, and an engine of one slot takes the whole tree."""
    _, cfg = _cfgs("kimi-k2-1t-a32b")
    full = T.init_cache(cfg, 3, 8, CPU)
    one = T.init_cache(cfg, 1, 8, CPU)
    for leaf in T._leaves({k: v for k, v in one.items() if k != "pos"}):
        leaf.fill_(1.0)
    _slot_assign(full, one, 1)
    pk = full["prefix"][0]["attn"]["k"]
    assert pk.shape == (3, 8, 4, 64)
    assert bool((pk[1] == 1).all()) and not bool(pk[[0, 2]].any())
    bk = full["blocks"]["l0"]["attn"]["v"]
    assert bk.shape == (1, 3, 8, 4, 64)
    assert bool((bk[:, 1] == 1).all()) and not bool(bk[:, [0, 2]].any())
    single = T.init_cache(cfg, 1, 8, CPU)
    _slot_assign(single, one, 0)
    assert all(bool((x == 1).all()) for x in T._leaves(single["prefix"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fixed_batch_and_engine_on_the_cpu(arch, capsys):
    """``launch.serve`` for each arch at ``--reduced``: the fixed-batch loop
    with a prompt past the window (one flash_decode a step on each global
    layer without a softcap), and ``--engine``."""
    calls = ops.kernel_calls["flash_decode"]
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "70", "--gen-len",
                      "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 2x70: ")
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
