"""The port's LM training path on the CPU against the JAX package:
configs, the LM stream, the dense transformer, the flat layout, the
fused flat-buffer GBA step and the pytree GBA step (Adam), at
``granite-8b.reduced()``.

Parameters are built by the JAX package and carried across with
``params_from_jax``; batches come from the numpy LM stream, identical in
both packages.  The fused step of both packages is called outside any
mesh.

Tolerances, with their reasons:
* configs, stream batches, the parameter handoff, the flat ravel and the
  buffer's tokens, fill and step are exact;
* float32: logits within 1e-6 of their largest magnitude and the loss
  within rtol 1e-6 (float32 sums in other orders; 7.5e-7 and 3.6e-7
  measured); gradients within 1e-5 of each leaf's largest magnitude
  (about 1e-6 measured); after 2 global steps of the fused step, losses
  within rtol 1e-6 and flat params and accumulator within rtol 1e-5 /
  atol 1e-7 (1.5e-8 absolute measured), as the card is held to the CPU;
* bfloat16: XLA and PyTorch round the bfloat16 intermediates at different
  places (XLA fuses elementwise chains and rounds once, PyTorch rounds
  after every operation), so values differ by a few bf16 ulps (2**-8
  relative): logits within 2**-6 of their largest magnitude, the loss
  within rtol 5e-4, gradients within 2**-5 of each leaf's largest
  magnitude; after 2 global steps, losses within rtol 5e-4, flat params
  within one bf16 ulp (rtol 2**-7) plus 2**-12 near zero, and the
  accumulator, which sums squares of those gradients, within rtol 1e-2.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.data import make_lm_stream as jax_make_lm_stream
from repro.launch.programs import build_programs as jax_build_programs
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.gba import FlatLayout
from repro_torch.data import make_lm_stream
from repro_torch.kernels import ops
from repro_torch.launch.programs import build_programs
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 32
TOL = {  # dtype -> (logits, loss rtol, grads, step loss rtol)
    "float32": (1e-6, 1e-6, 1e-5, 1e-6),
    "bfloat16": (2.0**-6, 5e-4, 2.0**-5, 5e-4),
}


@pytest.fixture(autouse=True)
def _outside_any_mesh():
    """Run the reference outside any mesh, as the port runs.
    ``repro.distributed.act_sharding`` keeps the activation sharding of the
    last sharded step built in this process in a module global, which
    would make the reference's forward constrain to that mesh; it is
    cleared for each test here and restored after."""
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
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab, step=0):
    return make_lm_stream(vocab, S, B, seed=0).batch(step)


def _close_to_max(got, want, frac, what):
    """|got - want| <= frac * max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    cfg, jcfg = get_config("granite-8b"), jax_get_config("granite-8b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.resolved_head_dim, cfg.num_repeats) == (
        jcfg.resolved_head_dim, jcfg.num_repeats)
    assert dataclasses.asdict(GBAConfig()) == dataclasses.asdict(
        JaxGBAConfig())


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "granite-8b"])
def test_archs_not_ported_raise_and_name_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("granite-9b")


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (512, 32, 2, 0), (49_152, 16, 4, 0), (1000, 8, 3, 5)])
def test_lm_stream_batches_are_identical(vocab, seq, batch, seed):
    mine = make_lm_stream(vocab, seq, batch, seed)
    ref = jax_make_lm_stream(vocab, seq, batch, seed)
    for step in (0, 1, 7):
        a, b = mine.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# parameters and the flat layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_carries_the_lm_tree_bit_for_bit(dtype):
    jcfg, cfg = _cfgs(dtype, layers=2)
    jp, tp = _params(jcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    layout = FlatLayout.from_params(tp)
    assert len(flat) == len(layout.paths)
    for (path, want), got in zip(flat, layout.leaves(tp)):
        name = "/".join(k.key for k in path)
        assert got.shape == want.shape, name
        want_dt = torch.float32 if name.endswith("scale") else {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        assert got.dtype == want_dt, name
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want).astype(np.float32))
    back = params_to_numpy(tp)
    assert back["blocks"]["l0"]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert T.param_count(tp) == JT.param_count(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_ravel_matches_jax_element_for_element(dtype):
    from repro.core.gba import FlatLayout as JaxFlatLayout
    jcfg, _ = _cfgs(dtype, layers=2)
    jp, tp = _params(jcfg)
    jlayout, layout = JaxFlatLayout.from_params(jp), FlatLayout.from_params(tp)
    assert (layout.sizes, layout.offsets, layout.total) == (
        jlayout.sizes, jlayout.offsets, jlayout.total)
    flat = layout.ravel(tp)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy().view(np.uint32),
                                  np.asarray(jlayout.ravel(jp)).view(
                                      np.uint32))
    back = layout.unravel(flat)
    for a, b in zip(layout.leaves(back), layout.leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != \
            flat.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(dtype, layers):
    jcfg, cfg = _cfgs(dtype, layers)
    jp, tp = _params(jcfg)
    b = _batch(cfg.vocab_size)
    logits = T.forward(tp, cfg, torch.from_numpy(b["tokens"]))
    jlogits, _ = JT.forward(jp, jcfg, jnp.asarray(b["tokens"]))
    assert logits.dtype == torch.float32 and logits.shape == (
        B, S, cfg.vocab_size)
    tol_logits, tol_loss, _, _ = TOL[dtype]
    _close_to_max(logits.numpy(), jlogits, tol_logits, "logits")
    loss = T.lm_loss(tp, cfg, torch.from_numpy(b["tokens"]),
                     torch.from_numpy(b["labels"]))
    jloss = JT.lm_loss(jp, jcfg, jnp.asarray(b["tokens"]),
                       jnp.asarray(b["labels"]))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol_loss)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(dtype, layers):
    jcfg, cfg = _cfgs(dtype, layers)
    jp, tp = _params(jcfg)
    b = _batch(cfg.vocab_size, step=3)
    jgrads = jax.grad(JT.lm_loss)(jp, jcfg, jnp.asarray(b["tokens"]),
                                  jnp.asarray(b["labels"]))
    layout = FlatLayout.from_params(tp)
    live = [x.detach().requires_grad_() for x in layout.leaves(tp)]
    loss = T.lm_loss(layout.unflatten(live), cfg,
                     torch.from_numpy(b["tokens"]),
                     torch.from_numpy(b["labels"]))
    grads = torch.autograd.grad(loss, live)
    for path, g, want in zip(layout.paths, grads, jax.tree.leaves(jgrads)):
        assert g.dtype == live[layout.paths.index(path)].dtype
        _close_to_max(g.float().numpy(), want, TOL[dtype][2],
                      "/".join(path))


FEATURES = {
    "moe": dict(block_pattern=("moe",), num_experts=4, experts_per_token=2),
    "mamba": dict(block_pattern=("mamba",), ssm_state=16),
    "cross": dict(block_pattern=("cross",)),
    "prefix": dict(prefix_layers=("global",), num_layers=3),
    "tied": dict(tie_embeddings=True),
    "logit-softcap": dict(logit_softcap=30.0),
    "attn-softcap": dict(attn_softcap=50.0),
    "window": dict(block_pattern=("local",), sliding_window=64),
    "q-chunk": dict(attn_q_chunk=16),
    "loss-chunk": dict(loss_seq_chunk=16),
    "remat": dict(remat_blocks=True),
    "layernorm": dict(norm="layernorm"),
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_check_supported_raises_for_what_is_not_ported(feature):
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              **FEATURES[feature])
    with pytest.raises(NotImplementedError, match="not ported"):
        T.check_supported(cfg)
    with pytest.raises(NotImplementedError):
        T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")


# ---------------------------------------------------------------------------
# the fused flat-buffer GBA step
# ---------------------------------------------------------------------------

def _run_both(dtype, tokens):
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    jgba = JaxGBAConfig(local_batch=B, buffer_size=4, staleness_tolerance=4)
    gba = GBAConfig(local_batch=B, buffer_size=4, staleness_tolerance=4)
    jprogs = jax_build_programs(jcfg, jgba, mode="fused", params=jp, lr=1e-3)
    progs = build_programs(cfg, gba, params=tp, mode="fused", lr=1e-3)
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for i, token in enumerate(tokens):
        b = stream.batch(i)
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
    return (jprogs, js, jl), (progs, ts, tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_step_matches_jax_over_two_global_steps_with_a_stale_slot(
        dtype):
    """8 microsteps at M = 4, iota 4, tokens ``i // M`` as the launcher
    gives them, except microstep 5, whose token -5 is 6 steps old at the
    second apply and is dropped."""
    tokens = [i // 4 for i in range(8)]
    tokens[5] = -5
    (jprogs, js, jl), (progs, ts, tl) = _run_both(dtype, tokens)
    _, _, _, step_rtol = TOL[dtype]
    np.testing.assert_allclose(tl, jl, rtol=step_rtol)
    jbuf, buf = js["buffer"], ts["buffer"]
    assert (buf["fill"], buf["step"]) == (int(jbuf["fill"]),
                                          int(jbuf["step"])) == (8, 2)
    np.testing.assert_array_equal(buf["tokens"].numpy(),
                                  np.asarray(jbuf["tokens"]))
    np.testing.assert_array_equal(buf["tokens"].numpy(), [1, -5, 1, 1])
    flat = progs.layout.ravel(ts["params"]).numpy()
    jflat = np.asarray(jprogs.layout.ravel(js["params"]))
    if dtype == "float32":
        np.testing.assert_allclose(flat, jflat, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ts["accum"].numpy(),
                                   np.asarray(js["accum"]), rtol=1e-5,
                                   atol=1e-7)
    else:
        np.testing.assert_allclose(flat, jflat, rtol=2.0**-7, atol=2.0**-12)
        np.testing.assert_allclose(ts["accum"].numpy(),
                                   np.asarray(js["accum"]), rtol=1e-2)
    for a, b in zip(progs.layout.leaves(ts["params"]),
                    jax.tree.leaves(js["params"])):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


def test_noop_microsteps_leave_params_and_accum_untouched():
    """On microsteps 1..M-1 of each global step the step returns the very
    params and accumulator it was given; the apply runs on microsteps 4
    and 8 alone, once each, and moves the params (all but the embedding
    rows of tokens no batch held, whose gradient is 0)."""
    _, cfg = _cfgs("float32")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    progs = build_programs(cfg, GBAConfig(local_batch=B, buffer_size=4),
                           params=params)
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    state, applied_at = progs.state, []
    for i in range(8):
        before = progs.layout.ravel(state["params"])
        accum = state["accum"].clone()
        calls = ops.kernel_calls["gba_apply_flat"]
        b = {k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
        new, _ = progs.step(state, b, i // 4)
        after = progs.layout.ravel(new["params"])
        if ops.kernel_calls["gba_apply_flat"] == calls + 1:
            applied_at.append(i + 1)
            assert (after != before).float().mean() > 0.9
            assert bool((new["accum"] > accum).any())
        else:
            assert ops.kernel_calls["gba_apply_flat"] == calls
            assert new["params"] is state["params"]
            assert torch.equal(after.view(torch.int32),
                               before.view(torch.int32))
            assert torch.equal(new["accum"].view(torch.int32),
                               accum.view(torch.int32))
        state = new
    assert applied_at == [4, 8]


# ---------------------------------------------------------------------------
# the pytree GBA step (Adam)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 3])
def test_pytree_step_matches_jax_over_8_microsteps_with_adam(m):
    """8 microsteps of ``build_programs(mode="pytree")`` with Adam at lr
    1e-3 and float32 accumulators in both packages, tokens ``i // M`` as
    the launcher gives them, except microstep 5, whose token -5 is stale
    beyond iota 4 and is weighed 0.

    Tolerances (measured at M = 4 and 3 beside each): losses within rtol
    1e-6 (1.4e-7: float32 sums in other orders); ``micro``, ``gstep`` and
    Adam's count exact; accumulators and Adam's moments within 1e-4 of
    their leaf's largest magnitude (1.9e-5); params within atol 1e-4, a
    tenth of lr (4.5e-5), with at most 1 element in 2,000 of each leaf
    beyond rtol 1e-5 / atol 1e-7 (22 of 131,072).  Adam moves an element
    by about lr whatever the size of its gradient, so where a gradient is
    near Adam's epsilon a difference in its last bits moves the update by
    a part of lr."""
    jcfg, cfg = _cfgs("float32")
    jp, tp = _params(jcfg)
    jgba = JaxGBAConfig(local_batch=B, buffer_size=m, staleness_tolerance=4)
    gba = GBAConfig(local_batch=B, buffer_size=m, staleness_tolerance=4)
    jprogs = jax_build_programs(jcfg, jgba, mode="pytree", params=jp,
                                lr=1e-3)
    progs = build_programs(cfg, gba, params=tp, mode="pytree", lr=1e-3)
    assert jprogs.optimizer.name == progs.optimizer.name == "adam"
    tokens = [i // m for i in range(8)]
    tokens[5] = -5
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for i, token in enumerate(tokens):
        b = stream.batch(i)
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert (ts["micro"], ts["gstep"]) == (int(js["micro"]),
                                          int(js["gstep"])) == (8, 8 // m)
    assert int(ts["opt"]["count"]) == int(js["opt"]["count"]) == 8 // m
    layout = FlatLayout.from_params(tp)
    for name, jtree, ttree in (("params", js["params"], ts["params"]),
                               ("acc", js["acc"], ts["acc"]),
                               ("m", js["opt"]["m"], ts["opt"]["m"]),
                               ("v", js["opt"]["v"], ts["opt"]["v"])):
        for path, got, want in zip(layout.paths, layout.leaves(ttree),
                                   jax.tree.leaves(jtree)):
            what = f"{name} {'/'.join(path)}"
            got, want = got.numpy(), np.asarray(want)
            assert got.shape == want.shape and got.dtype == want.dtype, what
            if name != "params":
                _close_to_max(got, want, 1e-4, what)
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=what)
            beyond = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-7
            assert beyond.sum() <= want.size / 2000, (what, beyond.sum())


def test_pytree_step_applies_on_every_mth_microstep_alone():
    """On microsteps 1..M-1 of each global step the step returns the very
    params and optimizer state it was given; on microsteps 4 and 8 alone
    Adam moves the params and the accumulator comes back all zero."""
    _, cfg = _cfgs("float32")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    progs = build_programs(cfg, GBAConfig(local_batch=B, buffer_size=4),
                           params=params, mode="pytree")
    layout = FlatLayout.from_params(params)
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    state, applied_at = progs.state, []
    for i in range(8):
        before = layout.ravel(state["params"])
        b = {k: torch.from_numpy(v) for k, v in stream.batch(i).items()}
        new, _ = progs.step(state, b, i // 4)
        after = layout.ravel(new["params"])
        acc = layout.ravel(new["acc"])
        if new["gstep"] > state["gstep"]:
            applied_at.append(i + 1)
            assert (after != before).float().mean() > 0.9
            assert not acc.any()
        else:
            assert new["params"] is state["params"]
            assert new["opt"] is state["opt"]
            assert torch.equal(after.view(torch.int32),
                               before.view(torch.int32))
            assert acc.any()
        state = new
    assert applied_at == [4, 8] and state["micro"] == 8


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _train(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_train_cli_runs_the_fused_step_on_the_cpu():
    proc = _train("--arch", "granite-8b", "--reduced", "--fused",
                  "--steps", "8", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fused gba_apply path (Adagrad): flat buffer (4, 918272)" in \
        proc.stdout
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("step    7") and "gstep 2" in last, proc.stdout


def test_train_cli_runs_the_pytree_step_with_adam_on_the_cpu():
    proc = _train("--arch", "granite-8b", "--reduced", "--steps", "8",
                  "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pytree GBA path (adam): M=4, iota=4" in proc.stdout
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("step    7") and "gstep 2" in last, proc.stdout


@pytest.mark.parametrize("args,says", [
    (("--arch", "granite-8b", "--reduced", "--mesh", "4x1"),
     "pytree step over PS workers is not ported"),
    (("--arch", "gemma2-27b", "--reduced", "--fused"), "not ported yet"),
])
def test_train_cli_refuses_what_the_port_does_not_run(args, says):
    proc = _train(*args, "--device", "cpu")
    assert proc.returncode != 0
    assert says in proc.stderr
