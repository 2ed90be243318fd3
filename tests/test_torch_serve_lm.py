"""The port's LM serving path on the CPU against the JAX package, at
``granite-8b.reduced()``: prefill, the decode step at a scalar position
(through ``flash_decode``'s plain version) and at a (B,) vector of slot
positions (the reference's masked attention), the continuous-batching
engine, and the ``launch.serve`` entry point.

Parameters are built by the JAX package and carried across with
``params_from_jax``, a copy: the port's decode writes its own cache in
place, and the JAX side keeps its own.  The reference's LM calls run
outside any mesh, with its module-global activation sharding cleared.

Tolerances, with their reasons:
* float32: logits within 1e-5 of their largest magnitude (float32 sums in
  other orders; about 8e-7 measured) and greedy tokens equal; the caches
  within 1e-5 of their largest magnitude;
* bfloat16: XLA and PyTorch round the bfloat16 intermediates at different
  places, so logits differ by a few bf16 ulps: within 2**-6 of their
  largest magnitude, as ``tests/test_torch_lm.py`` holds the forward,
  and so the caches (a second layer's inputs already differ by those
  roundings).  The two decode routes of the port differ by two bf16
  roundings (the kernel route keeps its probabilities in float32 and
  rounds its output to bfloat16; the masked route rounds the
  probabilities to bfloat16 and keeps a float32 output), so in bfloat16
  they too agree within 2**-6 of the largest logit, and in float32 within
  1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import (LiveSource, Request, ServingEngine,
                                 StaticSource, UpdateChannel)
from repro_torch.serving.engine import _slot_assign

CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}   # logits, of the largest


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


def _cfgs(dtype="float32", layers=None):
    jcfg = dataclasses.replace(jax_get_config("granite-8b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("granite-8b").reduced(), dtype=dtype)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return jcfg, cfg


def _params(jcfg, seed=0):
    jp = JT.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_to_max(got, want, frac, what=""):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _prompts(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_scalar_decode_match_the_reference(dtype):
    jcfg, cfg = _cfgs(dtype, layers=2)
    jp, p = _params(jcfg)
    toks = _prompts(cfg.vocab_size, 2, 9)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=16)
    calls = ops.kernel_calls["flash_decode"]
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks), cache_len=16)
    _close_to_max(logits, jl, TOL[dtype], "prefill logits")
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    assert int(cache["pos"]) == int(jc["pos"]) == 9
    for name in ("k", "v"):
        got = cache["blocks"]["l0"]["attn"][name]
        want = jc["blocks"]["l0"]["attn"][name]
        assert tuple(got.shape) == want.shape == (2, 2, 16, 4, 64)
        _close_to_max(got, want, TOL[dtype], f"cache {name}")
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for step in range(4):
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits, jl, TOL[dtype], f"decode step {step}")
        assert int(cache["pos"]) == int(jc["pos"]) == 10 + step
        if dtype == "float32":
            assert np.array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    # one flash_decode a layer a step: 2 layers, 4 steps
    assert ops.kernel_calls["flash_decode"] == calls + 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vector_decode_matches_the_reference_and_drops_past_the_cache(dtype):
    """Ragged slot positions, one of them at the cache's length: its write
    is dropped (the reference's ``mode="drop"``) and nothing else moves."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _params(jcfg, seed=1)
    toks = _prompts(cfg.vocab_size, 3, 12, seed=1)
    _, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), cache_len=12)
    _, cache = T.prefill(p, cfg, torch.from_numpy(toks), cache_len=12)
    pos = np.array([5, 11, 12], np.int32)         # 12 == L: dropped
    jc["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos)
    before = cache["blocks"]["l0"]["attn"]["k"].clone()
    calls = ops.kernel_calls["flash_decode"]
    tok = _prompts(cfg.vocab_size, 3, 1, seed=2)
    jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
    logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
    assert ops.kernel_calls["flash_decode"] == calls   # the masked route
    _close_to_max(logits, jl, TOL[dtype], "vector-pos decode")
    if dtype == "float32":
        assert np.array_equal(logits.argmax(-1).numpy(),
                              np.asarray(jl).argmax(-1))
    after = cache["blocks"]["l0"]["attn"]["k"]
    assert torch.equal(after[:, 2], before[:, 2])          # dropped
    changed = (after != before).flatten(3).any(-1)[0]      # (B, L)
    assert changed[0].nonzero().flatten().tolist() == [5]
    assert changed[1].nonzero().flatten().tolist() == [11]
    _close_to_max(after, jc["blocks"]["l0"]["attn"]["k"], TOL[dtype],
                  "cache after")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_and_masked_route_agree(dtype):
    """One decode step with every row at pos = 9: as a scalar (the
    ``flash_decode`` route) and as a (B,) vector (the masked route)."""
    _, cfg = _cfgs(dtype, layers=2)
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                     device=CPU)
    toks = torch.from_numpy(_prompts(cfg.vocab_size, 3, 9, seed=3))
    _, c_scalar = T.prefill(p, cfg, toks, cache_len=20)
    _, c_vector = T.prefill(p, cfg, toks, cache_len=20)
    c_vector["pos"] = torch.full((3,), 9, dtype=torch.int32)
    tok = toks[:, -1:]
    for _ in range(3):
        l_s, c_scalar = T.decode_step(p, cfg, tok, c_scalar)
        l_v, c_vector = T.decode_step(p, cfg, tok, c_vector)
        _close_to_max(l_s, l_v, TOL[dtype], "routes")
        tok = l_v.argmax(-1).to(torch.int32)
    assert torch.equal(c_scalar["pos"], torch.tensor(12, dtype=torch.int32))


def test_slot_assign_writes_only_the_slot_rows():
    _, cfg = _cfgs(layers=2)
    full = T.init_cache(cfg, 3, 8, CPU)
    one = T.init_cache(cfg, 1, 8, CPU)
    for leaf in (one["blocks"]["l0"]["attn"]["k"],
                 one["blocks"]["l0"]["attn"]["v"]):
        leaf.fill_(1.0)
    one["pos"] = torch.tensor(5, dtype=torch.int32)
    _slot_assign(full, one, 1)
    k = full["blocks"]["l0"]["attn"]["k"]
    assert k.shape == (2, 3, 8, 4, 64)
    assert bool((k[:, 1] == 1).all()) and not bool(k[:, [0, 2]].any())
    assert int(full["pos"]) == 0                    # engine-owned, untouched
    single = T.init_cache(cfg, 1, 8, CPU)            # an engine of one slot
    _slot_assign(single, one, 0)
    assert bool((single["blocks"]["l0"]["attn"]["v"] == 1).all())


# ---------------------------------------------------------------------------
# the continuous-batching engine (ports of tests/test_serving.py and the LM
# case of tests/test_serving_live.py, for granite-8b)
# ---------------------------------------------------------------------------

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


def test_engine_matches_offline_and_the_reference_engine():
    jcfg, cfg = _cfgs()
    jp, params = _params(jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    n_new = 6
    engine = ServingEngine(params, cfg, num_slots=2, max_len=64)
    ref = JaxServingEngine(jp, jcfg, num_slots=2, max_len=64)
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
        ref.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new))
    stats = engine.run()
    ref_stats = ref.run()
    assert stats["completed"] == 3
    keys = ("completed", "decode_steps", "decode_tokens", "slot_utilization",
            "param_version", "param_step", "syncs_adopted",
            "clamped_requests")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert set(stats) == set(ref_stats)
    for req, jreq in zip(engine.completed, ref.completed):
        assert req.uid == jreq.uid and req.output == jreq.output
        assert req.admitted_at_step == jreq.admitted_at_step
        assert req.output == _offline_greedy(cfg, params, req.prompt, n_new)


def test_slot_reuse_and_utilization():
    _, cfg = _cfgs()
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    rng = np.random.default_rng(1)
    engine = ServingEngine(params, cfg, num_slots=2, max_len=32)
    for i in range(5):
        engine.submit(Request(uid=i,
                              prompt=rng.integers(0, cfg.vocab_size,
                                                  size=4).astype(np.int32),
                              max_new_tokens=4))
    stats = engine.run()
    assert stats["completed"] == 5
    assert stats["decode_tokens"] == 5 * 3  # first token from prefill
    assert 0.5 <= stats["slot_utilization"] <= 1.0


def test_admission_clamp_keeps_writes_in_cache():
    """A request with prompt_len + max_new_tokens > max_len is clamped to
    the cache's room; its output is the in-budget request's."""
    _, cfg = _cfgs()
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)
    engine = ServingEngine(params, cfg, num_slots=1, max_len=16)
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=50))
    stats = engine.run()
    assert stats["completed"] == 1
    assert stats["clamped_requests"] == 1
    req = engine.completed[0]
    assert len(req.output) == 16 - 10          # clamped budget
    assert int(engine.slot_pos.max()) < 16     # every write stayed inside
    ref = ServingEngine(params, cfg, num_slots=1, max_len=16)
    ref.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    ref.run()
    assert ref.clamped_requests == 0
    assert req.output == ref.completed[0].output
    with pytest.raises(ValueError, match="does not fit"):
        ref.submit(Request(uid=1, prompt=np.zeros(16, np.int32),
                           max_new_tokens=1))


def test_eos_termination():
    _, cfg = _cfgs()
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
    ref = _offline_greedy(cfg, params, prompt, 8)
    eos = ref[2]  # force early stop at the 3rd generated token
    engine = ServingEngine(params, cfg, num_slots=1, max_len=32)
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=8,
                          eos_id=eos))
    engine.run()
    req = engine.completed[0]
    assert req.output[-1] == eos and len(req.output) <= 3


def test_lm_engine_adopts_only_at_step_boundary():
    _, cfg = _cfgs()
    p0 = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device=CPU)
    p1 = T.init_model(cfg, generator=torch.Generator().manual_seed(7),
                      device=CPU)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    chan = UpdateChannel()
    live = LiveSource(chan, p0, start=False)
    eng = ServingEngine(live, cfg, num_slots=1, max_len=32)
    eng.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=8))
    # reference: the same request, params swapped by hand at the same step
    # boundary; equality shows one version pinned per step
    ref = ServingEngine(p0, cfg, num_slots=1, max_len=32)
    ref.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=8))
    for k in range(7):
        if k == 3:                            # sync lands mid-decode
            chan.publish(p1, 100)
            live.sync_now()
            ref.params = p1
        eng.step()
        ref.step()
    assert eng.completed and ref.completed
    assert eng.completed[0].output == ref.completed[0].output
    assert eng.syncs_adopted == 1
    assert eng.param_version == 2 and eng.param_step == 100
    eng.close()


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_serve_fixed_batch_on_the_cpu(capsys):
    calls = ops.kernel_calls["flash_decode"]
    out = serve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                      "--batch", "4", "--prompt-len", "16", "--gen-len",
                      "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 4x16: ") and lines[0].endswith(" ms")
    assert lines[1].startswith("decode 7 steps: ") and "tok/s" in lines[1]
    assert out["tokens"].shape == (4, 8) and out["decode_steps"] == 7
    # granite-8b.reduced() has one layer: one flash_decode a step
    assert ops.kernel_calls["flash_decode"] == calls + 7


def test_serve_engine_on_the_cpu(capsys):
    stats = serve.main(["--arch", "granite-8b", "--reduced", "--device",
                        "cpu", "--engine", "--batch", "2", "--requests", "3",
                        "--prompt-len", "8", "--gen-len", "4"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("engine: 3 completed in ")
    assert "slot util" in line and "param v1 (step 0)" in line
    assert stats["completed"] == 3 and stats["decode_tokens"] == 3 * 3


def test_serve_engine_from_a_checkpoint_subtree(tmp_path, capsys):
    """``--ckpt DIR --ckpt-select params``: the JAX package's checkpoint
    of a train state, the newest step's file, its ``params`` subtree."""
    from repro.checkpoint import store as jax_ckpt
    jcfg, cfg = _cfgs("bfloat16")
    jp, p = _params(jcfg, seed=4)
    jax_ckpt.save_pytree(str(tmp_path / "ckpt_00000007.npz"),
                         {"params": jp, "step": np.int32(7)})
    stats = serve.main(["--arch", "granite-8b", "--reduced", "--device",
                        "cpu", "--engine", "--batch", "2", "--requests", "2",
                        "--prompt-len", "6", "--gen-len", "3", "--ckpt",
                        str(tmp_path), "--ckpt-select", "params"])
    assert "param v1 (step 7)" in capsys.readouterr().out
    assert stats["completed"] == 2 and stats["param_step"] == 7
    src = StaticSource.from_checkpoint(str(tmp_path), select="params",
                                       device=CPU)
    got = src.snapshot().params["blocks"]["l0"]["mlp"]["wo"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, p["blocks"]["l0"]["mlp"]["wo"])


def test_serve_refuses_an_arch_that_is_not_ported(monkeypatch):
    """Every architecture id and every config field is ported now: a
    config with a layer kind that does not exist exits non-zero before
    any weights are made."""
    unknown = dataclasses.replace(get_config("granite-8b"),
                                  block_pattern=("conv",))
    monkeypatch.setattr(serve, "get_config", lambda arch: unknown)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "granite-8b", "--device", "cpu"])


@pytest.mark.parametrize("entry", ["serve", "serve_engine", "init_cache"])
def test_default_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    calls = {
        "serve": lambda: serve.main(["--arch", "granite-8b", "--reduced"]),
        "serve_engine": lambda: serve.main(["--arch", "granite-8b",
                                            "--reduced", "--engine"]),
        "init_cache": lambda: T.init_cache(_cfgs()[1], 1, 8),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
