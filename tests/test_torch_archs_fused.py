"""The fused flat-buffer GBA step of the attention-family architectures on
the CPU against the JAX package: gemma2-27b, gemma3-12b, starcoder2-3b,
phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b at ``.reduced()``, 80 tokens a
sequence, past the reduced window of 64.  The other half of
``tests/test_torch_archs_train.py``, whose parameters, batches and
fixtures it shares (see there).

For each architecture the fused step over 2 global steps at M = 4 with a
stale slot against the reference's ``build_programs(mode="fused")``; then
kimi-k2's sharded fused step over 4 layer-grouped shards (``--fused
--mesh 4x1``, the reference's documented command) against the
single-layout one, the launcher's fused step for the five, and
kimi-k2's list of prefix layers through the int8 wire step and the
switching harness's swaps.

In the reference's fused step the Pallas ``gba_apply`` runs as its plain
reference (``repro.kernels.ref.gba_apply_ref``, the oracle of
``tests/test_kernels.py``), since in interpret mode it takes some 19 s an
apply at gemma3-12b's 4.2 M parameters; the port's plain ``gba_apply`` is
held to the Pallas kernel bit for bit in ``tests/test_torch_gba_apply.py``.

MoE routes: the float32 steps hold every route of the port above a margin
of 1e-4 (``tests/test_torch_archs_train.py``).  In bfloat16 the margins
that 8 microsteps of 160 tokens leave lie within bf16's rounding of the
router input (8.8e-6 at kimi-k2's second microstep), so the bfloat16
steps run for the three architectures without experts; the MoE's
bfloat16 gradients are held at a seed without a near-tie.

Tolerances, as ``tests/test_torch_lm.py`` holds granite-8b's fused step
(the measured worst beside each): float32 losses within rtol 1e-6
(2.1e-7), flat params and accumulator within rtol 1e-5 / atol 1e-7 (1.2e-7
absolute); bfloat16 losses within rtol 5e-4 (1.3e-4), params within one
bf16 ulp plus 2**-12, the accumulator within rtol 1e-2; buffer tokens,
fill and step exact.  kimi-k2's sharded step is bit for bit the single
layout's: the same arithmetic on every element, in 4 launches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jax_ops
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.kernels.ref import gba_apply_ref as jax_gba_apply_ref
from repro.launch.programs import build_programs as jax_build_programs
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.programs import build_programs
from repro_torch.models import transformer as T
from test_torch_archs_train import (  # noqa: F401 (fixtures)
    ARCHS, B, IOTA, KIMI, LR, M, MARGIN, TOKENS, TOL, _margins, _stream,
    _outside_any_mesh, models, one_torch_thread)


@pytest.fixture
def jax_apply_by_its_reference(monkeypatch):
    """The reference's fused step applies through ``gba_apply_ref``."""
    def plain(p, a, buf, tokens, step, lr, *, iota, eps=1e-10,
              interpret=None):
        return jax_gba_apply_ref(p, a, buf, tokens, step, lr, iota=iota,
                                 eps=eps)
    monkeypatch.setattr(jax_ops, "gba_apply_flat", plain)


@pytest.mark.parametrize("arch,dtype", [
    *((a, "float32") for a in ARCHS),
    *((a, "bfloat16") for a in ARCHS if not get_config(a).num_experts)])
def test_fused_step_matches_jax_over_two_global_steps_with_a_stale_slot(
        arch, dtype, models, monkeypatch, jax_apply_by_its_reference):
    """8 microsteps at M = 4, iota 4, the launcher's tokens ``i // M``
    except microstep 5's -5, which is 6 steps old at the second apply and
    dropped; one ``gba_apply`` at microsteps 4 and 8 alone."""
    jcfg, cfg, jp, p = models(arch, dtype)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                               params=jp, lr=LR)
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="fused",
                           lr=LR)
    margins = _margins(monkeypatch)
    js, ts, jl, tl, applied = jprogs.state, progs.state, [], [], []
    for b, token in zip(_stream(cfg), TOKENS):
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        calls = ops.kernel_calls["gba_apply_flat"]
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
        applied.append(ops.kernel_calls["gba_apply_flat"] - calls)
    assert applied == [0, 0, 0, 1, 0, 0, 0, 1]
    if dtype == "float32":
        assert min(margins, default=1.0) > MARGIN
    np.testing.assert_allclose(tl, jl, rtol=TOL[dtype][1])
    jbuf, buf = js["buffer"], ts["buffer"]
    assert (buf["fill"], buf["step"]) == (int(jbuf["fill"]),
                                          int(jbuf["step"])) == (8, 2)
    np.testing.assert_array_equal(buf["tokens"].numpy(), [1, -5, 1, 1])
    np.testing.assert_array_equal(np.asarray(jbuf["tokens"]), [1, -5, 1, 1])
    flat = progs.layout.ravel(ts["params"]).numpy()
    jflat = np.asarray(jprogs.layout.ravel(js["params"]))
    accum, jaccum = ts["accum"].numpy(), np.asarray(js["accum"])
    if dtype == "float32":
        np.testing.assert_allclose(flat, jflat, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(accum, jaccum, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(flat, jflat, rtol=2.0**-7, atol=2.0**-12)
        np.testing.assert_allclose(accum, jaccum, rtol=1e-2)
    for a, b in zip(progs.layout.leaves(ts["params"]),
                    jax.tree.leaves(js["params"])):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)


def test_kimi_sharded_fused_step_is_the_single_layout_step_bit_for_bit(
        models):
    """``build_programs(mode="fused", workers=4)`` (layer-grouped, as
    ``--fused --mesh 4x1`` builds it) against the single-layout fused step
    from the same params and batches: losses, params and accumulator bit
    for bit after every microstep, 4 ``gba_apply`` launches an apply."""
    _, cfg, _, p = models(KIMI, "float32")
    gba = GBAConfig(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    one = build_programs(cfg, gba, params=p, mode="fused", lr=LR)
    four = build_programs(cfg, gba, params=T._map(p, torch.clone),
                          mode="fused", lr=LR, workers=4, place_state=False)
    lay = four.layout
    assert lay.num_shards == 4 and "prefix.#0" in lay.group_keys
    s1, s4 = one.state, four.state
    for i, (b, token) in enumerate(zip(_stream(cfg), TOKENS)):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        s1, l1 = one.step(s1, batch, token)
        calls = ops.kernel_calls["gba_apply_flat"]
        s4, l4 = four.step(s4, batch, token)
        assert ops.kernel_calls["gba_apply_flat"] - calls == (
            4 if (i + 1) % M == 0 else 0)
        assert torch.equal(l1.view(torch.int32), l4.view(torch.int32))
        for a, b in zip(one.layout.leaves(s1["params"]),
                        lay.leaves(s4["params"])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    accum = lay.unravel(s4["accum"], torch.float32)
    for a, b in zip(one.layout.leaves(one.layout.unravel(s1["accum"])),
                    lay.leaves(accum)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_fused_step_on_the_cpu(arch, capsys):
    """``launch.train --arch X --reduced --fused``: 8 finite losses, one
    ``gba_apply`` at each of the two global steps."""
    calls = ops.kernel_calls["gba_apply_flat"]
    losses = train.main(["--arch", arch, "--reduced", "--fused", "--steps",
                         "8", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert ops.kernel_calls["gba_apply_flat"] - calls == 2
    assert "fused gba_apply path (Adagrad): flat buffer (4, " in out
    assert "gstep 2" in out.strip().splitlines()[-1]


def test_train_cli_fused_mesh_4x1_for_kimi(capsys):
    """The reference's documented ``--arch kimi-k2-1t-a32b --reduced
    --fused --mesh 4x1``: the sharded fused step over 4 layer-grouped
    shards, the prefix layer a group of its own, and the single-layout
    step's losses."""
    args = ["--arch", KIMI, "--reduced", "--fused", "--steps", "8", "--seq",
            "32", "--device", "cpu"]
    sharded = train.main(args + ["--mesh", "4x1"])
    out = capsys.readouterr().out
    assert "sliced over data=4" in out and "prefix.#0=" in out, out
    assert sharded == train.main(args)


@pytest.mark.parametrize("mode", ["wire-int8", "autoswitch"])
def test_kimi_runs_the_wire_and_the_switching_harness(mode, capsys):
    """kimi-k2's prefix list through the worker-parallel paths of
    ``--mesh 4x1``: the int8 wire step (2 float32 warmup and 2 quantized
    global steps) and the switching harness on the strained plan, whose
    swap between the pytree sync state and the flat async state is
    verified bit for bit over the list; finite losses."""
    args = ["--arch", KIMI, "--reduced", "--mesh", "4x1", "--seq", "32",
            "--device", "cpu"]
    if mode == "wire-int8":
        losses = train.main(args + ["--fused", "--compress", "int8",
                                    "--compress-warmup", "2", "--steps",
                                    "4"])
        assert "quantized wire (int8): 4 workers x 5 groups" in \
            capsys.readouterr().out
    else:
        res = train.main(args + ["--autoswitch", "--batches", "40"])
        assert res.switch_count >= 1 and res.swaps_verified >= 1
        losses = res.losses
    assert len(losses) >= 4 and np.isfinite(losses).all()
