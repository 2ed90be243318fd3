"""The port's sharded PS layout and sharded fused step against the JAX
package, on the CPU.

The reference's sharded fused step (``build_programs(mode="fused",
mesh=...)``) fails on JAX 0.9 (``ShardingTypeError`` in
``flat_buffer_push``), so its single-host fused step, one ``gba_apply``
launch on the ``FlatLayout``, is the oracle: the sharded step does the
same arithmetic on every element, in W launches, and Adagrad on a
zero-padded column is the identity.  The layout's helpers are host
integers and are held to the reference's ``ShardedFlatLayout`` exactly;
``per_leaf_kernel_apply`` runs on both sides without a mesh, the
reference's ``gba_apply`` in interpret mode.

The step tests swap the LM loss of both packages for one whose gradients
are exact (``mean(x) * sum of squares``, ``x`` in multiples of 1/8, the
squares folded in halves; ``repro_torch.distributed.selfcheck``'s), on a
tree whose leaves are not tile multiples, so params and accumulator can be
held bit for bit over 2 global steps.  The LM itself at
``granite-8b.reduced()`` in float32 is held within
``tests/test_torch_lm.py``'s tolerance for the fused step (rtol 1e-5,
atol 1e-7 after 2 global steps), since the two frameworks sum in other
orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.programs as jax_programs
from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.core.compression import CompressionPolicy as JaxPolicy
from repro.core.flat_sharded import ShardedFlatLayout as JaxLayout
from repro.core.flat_sharded import \
    per_leaf_kernel_apply as jax_per_leaf_kernel_apply
from repro.models import transformer as JT
import repro_torch.launch.programs as programs
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import CompressionPolicy
from repro_torch.core.flat_sharded import (ShardedFlatLayout,
                                           init_sharded_flat_buffer,
                                           per_leaf_kernel_apply,
                                           sharded_flat_push,
                                           sharded_flat_push_and_maybe_apply)
from repro_torch.data import make_lm_stream
from repro_torch.distributed import selfcheck
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import transformer as T

M, IOTA, LR, B, S = 4, 2, 0.05, 8, 32
# microstep i carries the launcher's token i // M, but microstep 5's is
# -5: 5 steps old at the second apply, which Eq. (1) drops at iota 2
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]


@pytest.fixture(autouse=True)
def _outside_any_mesh():
    """The reference runs outside any mesh (``tests/test_torch_lm.py``)."""
    from repro.distributed import act_sharding
    saved = act_sharding._ACT_SHARDING, act_sharding._EXPERT_SHARDING
    act_sharding.set_act_spec(None)
    act_sharding.set_expert_spec(None)
    yield
    act_sharding.set_act_spec(saved[0])
    act_sharding.set_expert_spec(saved[1])


def _small_tree() -> dict:
    return selfcheck.problem(4)[0]


def _granite_tree() -> dict:
    return T.init_model(get_config("granite-8b").reduced(),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")


# tree -> (params, the port's grouping, the reference's grouping)
TREES = {"small": (_small_tree, lambda path: path[0],
                   lambda names: names[0]),
         "granite": (_granite_tree, T.param_group_key, JT.param_group_key)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.float().numpy())


def _layouts(tree_name, shards, grouped, tile=2048):
    make, group_by, jax_group_by = TREES[tree_name]
    params = make()
    lay = ShardedFlatLayout.from_params(params, shards, tile,
                                        group_by=group_by if grouped
                                        else None)
    ref = JaxLayout.from_params(_to_jax(params), shards, tile,
                                group_by=jax_group_by if grouped else None)
    return params, lay, ref


# ---------------------------------------------------------------------------
# the layout's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "flat"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_layout_helpers_match_the_reference(tree, shards, grouped):
    _, lay, ref = _layouts(tree, shards, grouped,
                           tile=256 if tree == "small" else 2048)
    assert lay.group_keys == ref.group_keys
    assert lay.num_groups == (ref.num_groups if grouped else 1)
    assert lay.peak_gather_bytes == ref.peak_gather_bytes
    assert lay.full_gather_bytes == ref.full_gather_bytes
    if grouped:
        assert lay.peak_gather_bytes < lay.full_gather_bytes
    assert lay.group_table() == ref.group_table()
    for scheme in ("none", "int8", "onebit"):
        assert lay.group_table(CompressionPolicy(scheme=scheme)) == \
            ref.group_table(JaxPolicy(scheme=scheme))
        assert lay.wire_state_shapes(shards, scheme) == \
            ref.wire_state_shapes(shards, scheme)
    for s in range(shards):
        assert lay.leaves_in_shard(s) == ref.leaves_in_shard(s)
    with pytest.raises(IndexError):
        lay.leaves_in_shard(shards)


def test_wire_state_shapes_refuses_an_unknown_scheme():
    _, lay, _ = _layouts("small", 2, True)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        lay.wire_state_shapes(2, "fp8")


# ---------------------------------------------------------------------------
# the sharded buffer and the per-leaf oracle
# ---------------------------------------------------------------------------

def _apply_inputs(lay, seed=3):
    """A raveled tree, an accumulator, an (M, padded_total) buffer of
    gradients (zero in the padding) and tokens, one slot stale."""
    rng = np.random.default_rng(seed)
    real = torch.zeros(lay.padded_total, dtype=torch.bool)
    real[lay.ravel(lay.unflatten(
        [torch.ones(s) for s in lay.shapes])) != 0] = True
    grads = torch.from_numpy(rng.standard_normal(
        (M, lay.padded_total)).astype(np.float32)) * real
    accum = torch.from_numpy(rng.uniform(
        0.05, 1.0, lay.padded_total).astype(np.float32))
    tokens = torch.tensor([3, 3, 0, 3], dtype=torch.int32)
    return grads, accum, tokens


def test_per_leaf_kernel_apply_matches_the_reference_and_the_shards():
    """The per-leaf chain (one launch per leaf) against the reference's,
    run without a mesh, and against the sharded push and apply (one
    launch per shard), bit for bit, on an ungrouped layout of 4 shards."""
    params, lay, ref = _layouts("small", 4, False, tile=256)
    grads, accum, tokens = _apply_inputs(lay)
    flat = lay.ravel(params)
    want_p, want_a = jax_per_leaf_kernel_apply(
        ref, jnp.asarray(flat.numpy()), jnp.asarray(accum.numpy()),
        jnp.asarray(grads.numpy()), jnp.asarray(tokens.numpy()),
        jnp.int32(3), LR, iota=IOTA, interpret=True)
    p, a = flat.clone(), accum.clone()
    calls = ops.kernel_calls["gba_apply_flat"]
    per_leaf_kernel_apply(lay, p, a, grads, tokens, 3, LR, iota=IOTA)
    assert ops.kernel_calls["gba_apply_flat"] - calls == len(lay.sizes)
    np.testing.assert_array_equal(p.numpy().view(np.int32),
                                  np.asarray(want_p).view(np.int32))
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  np.asarray(want_a).view(np.int32))

    _, buf = init_sharded_flat_buffer(params, M, 4, tile=256)
    buf["step"] = 3
    sp, sa = flat.clone(), accum.clone()
    calls = ops.kernel_calls["gba_apply_flat"]
    for j in range(M):
        sp, sa, applied, buf = sharded_flat_push_and_maybe_apply(
            buf, grads[j], int(tokens[j]), sp, sa, LR, layout=lay,
            iota=IOTA)
        assert applied == (j == M - 1)
    assert ops.kernel_calls["gba_apply_flat"] - calls == 4
    assert buf["step"] == 4
    assert torch.equal(sp.view(torch.int32), p.view(torch.int32))
    assert torch.equal(sa.view(torch.int32), a.view(torch.int32))


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_buffer_is_shard_major_with_slot_views(shards):
    """``grads[j]`` is slot ``j`` as ``(S, shard_size)``; each shard's ``(M,
    shard_size)`` block is contiguous for its launch; a push that does not
    fill the buffer leaves params and accumulator alone."""
    params, lay, _ = _layouts("small", shards, True, tile=256)
    _, buf = init_sharded_flat_buffer(params, M, shards, tile=256,
                                      group_by=lambda p: p[0])
    assert tuple(buf["grads"].shape) == (M, shards, lay.shard_size)
    assert all(b.is_contiguous() for b in buf["grads"].unbind(1))
    g = lay.ravel(params)
    p, a = torch.zeros_like(g), torch.ones_like(g)
    p2, a2, applied, buf = sharded_flat_push_and_maybe_apply(
        buf, g, 7, p, a, LR, layout=lay, iota=IOTA)
    assert not applied and p2 is p and a2 is a
    assert not p.any() and bool((a == 1).all())
    assert torch.equal(buf["grads"][0].reshape(-1), g)
    assert (buf["fill"], buf["step"], int(buf["tokens"][0])) == (1, 0, 7)


def test_a_run_of_held_shards_applies_as_the_whole_buffer():
    """A process holding shards 2 and 3 of 4 (``held=2``): its buffer has
    their two blocks, and its push and apply of their run of a gradient
    give their run of the whole buffer's params and accumulator, bit for
    bit; a run of the wrong length is refused."""
    params, lay, _ = _layouts("small", 4, True, tile=256)
    _, whole = init_sharded_flat_buffer(params, M, 4, tile=256,
                                        group_by=lambda p: p[0])
    _, part = init_sharded_flat_buffer(params, M, 4, tile=256,
                                       group_by=lambda p: p[0], held=2)
    assert tuple(part["grads"].shape) == (M, 2, lay.shard_size)
    run = slice(2 * lay.shard_size, 4 * lay.shard_size)
    grads, accum, _ = _apply_inputs(lay)
    p, a = lay.ravel(params), accum.clone()
    pr, ar = p[run].clone(), a[run].clone()
    for j, token in enumerate([3, 0, 3, 3]):
        p, a, applied, whole = sharded_flat_push_and_maybe_apply(
            whole, grads[j], token, p, a, LR, layout=lay, iota=IOTA)
        pr, ar, run_applied, part = sharded_flat_push_and_maybe_apply(
            part, grads[j][run], token, pr, ar, LR, layout=lay, iota=IOTA)
        assert applied == run_applied == (j == M - 1)
    assert torch.equal(pr.view(torch.int32), p[run].view(torch.int32))
    assert torch.equal(ar.view(torch.int32), a[run].view(torch.int32))
    with pytest.raises(ValueError, match="takes a"):
        sharded_flat_push(lay, part, grads[0], 0)
    with pytest.raises(ValueError, match="1 to 4 shards"):
        init_sharded_flat_buffer(params, M, 4, tile=256, held=5)


def test_one_rank_world_sharded_lm_step_is_the_in_process_step(tmp_path):
    """``build_programs(mode="fused", workers=4, world=)`` over a gloo world
    of one rank (all 4 shards, the whole batch: the card's NCCL world) is
    the in-process step bit for bit: the float32 LM's losses, params and
    accumulator over 4 microsteps at M = 2 (2 applies)."""
    from repro_torch.distributed import process_group
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    gba = GBAConfig(local_batch=2, buffer_size=2, staleness_tolerance=4)
    stream = make_lm_stream(cfg.vocab_size, S, 2, seed=0)
    threads = torch.get_num_threads()
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cpu", timeout=60.0, threads=threads)
    try:
        runs = []
        for w in (world, programs.inprocess):
            progs = programs.build_programs(
                cfg, gba, params=_granite_f32(cfg), mode="fused", lr=1e-3,
                workers=4, world=w)
            st, losses = progs.state, []
            for i in range(4):
                st, loss = progs.step(st, {
                    k: torch.from_numpy(v)
                    for k, v in stream.batch(i).items()}, i // 2)
                losses.append(loss)
            runs.append((progs.layout, st, torch.stack(losses)))
    finally:
        process_group.leave()
        torch.set_num_threads(threads)
    (lay, got, gl), (_, want, wl) = runs
    assert torch.equal(gl.view(torch.int32), wl.view(torch.int32))
    assert torch.equal(got["accum"].view(torch.int32),
                       want["accum"].view(torch.int32))
    for a, b in zip(lay.leaves(got["params"]), lay.leaves(want["params"])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _granite_f32(cfg) -> dict:
    return T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")


def test_per_leaf_kernel_apply_refuses_grouped_layouts():
    params, lay, ref = _layouts("small", 2, True, tile=256)
    grads, accum, tokens = _apply_inputs(lay)
    with pytest.raises(ValueError, match="single-group layout"):
        per_leaf_kernel_apply(lay, lay.ravel(params), accum, grads, tokens,
                              3, LR, iota=IOTA)
    with pytest.raises(ValueError, match="single-group layout"):
        jax_per_leaf_kernel_apply(ref, None, None, None, None, None, LR,
                                  iota=IOTA)


# ---------------------------------------------------------------------------
# the sharded fused step
# ---------------------------------------------------------------------------

def _jax_fold(v):
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = jnp.concatenate([v, jnp.zeros((n - v.shape[0],), v.dtype)])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def _jax_exact_loss(params, cfg, batch):
    s = None
    for leaf in jax.tree.leaves(params):
        f = leaf.astype(jnp.float32).reshape(-1)
        s = _jax_fold(f * f) if s is None else s + _jax_fold(f * f)
    return jnp.mean(batch["x"]) * s


def _exact_loss(params, cfg, batch):
    return selfcheck.loss_fn(params, batch)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "flat"])
@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_fused_step_is_bit_identical_to_the_single_host_step(
        workers, grouped, monkeypatch):
    """``build_programs(mode="fused", workers=W)`` against the reference's
    single-host ``build_programs(mode="fused")``, both on the exact loss,
    8 microsteps at M = 4 (2 global steps, one slot dropped): params and
    accumulator bit for bit after every microstep, W ``gba_apply``
    launches at microsteps 4 and 8 and none at the others."""
    monkeypatch.setattr(jax_programs, "_loss_from_batch", _jax_exact_loss)
    monkeypatch.setattr(programs, "_loss_from_batch", _exact_loss)
    params, xs = selfcheck.problem(4)
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("granite-8b").reduced(),
                               dtype="float32")
    jprogs = jax_programs.build_programs(
        jcfg, JaxGBAConfig(local_batch=B, buffer_size=M,
                           staleness_tolerance=IOTA),
        mode="fused", params=_to_jax(params), lr=LR)
    progs = programs.build_programs(
        cfg, GBAConfig(local_batch=B, buffer_size=M,
                       staleness_tolerance=IOTA),
        params=params, mode="fused", lr=LR, workers=workers,
        layer_groups=grouped)
    lay = progs.layout
    assert isinstance(lay, ShardedFlatLayout)
    assert lay.num_shards == workers
    assert lay.num_groups == (3 if grouped else 1)
    js, ts = jprogs.state, progs.state
    for i, token in enumerate(TOKENS):
        x = xs[i % xs.shape[0]]
        js, jloss = jprogs.step(js, {"x": jnp.asarray(x.numpy())},
                                jnp.asarray(token, jnp.int32))
        calls = ops.kernel_calls["gba_apply_flat"]
        ts, loss = progs.step(ts, {"x": x}, token)
        launched = ops.kernel_calls["gba_apply_flat"] - calls
        assert launched == (workers if (i + 1) % M == 0 else 0)
        assert loss.numpy().view(np.int32) == _bits(jloss)
        for got, want in zip(lay.leaves(ts["params"]),
                             jax.tree.leaves(js["params"])):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        accum = lay.unravel(ts["accum"], torch.float32)
        jaccum = jprogs.layout.unravel(js["accum"])
        for got, want in zip(lay.leaves(accum), jax.tree.leaves(jaccum)):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert ts["buffer"]["step"] == int(js["buffer"]["step"]) == 2
    np.testing.assert_array_equal(ts["buffer"]["tokens"].numpy(),
                                  np.asarray(js["buffer"]["tokens"]))


def test_sharded_lm_step_matches_the_reference_lm_step():
    """The LM itself, ``granite-8b.reduced()`` in float32, 4 layer-grouped
    shards against the reference's single-host fused step over 2 global
    steps: losses within rtol 1e-6, params and accumulator within rtol
    1e-5 / atol 1e-7 (``tests/test_torch_lm.py``'s bounds)."""
    jcfg = dataclasses.replace(jax_get_config("granite-8b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    gba = dict(local_batch=2, buffer_size=M, staleness_tolerance=4)
    jprogs = jax_programs.build_programs(jcfg, JaxGBAConfig(**gba),
                                         mode="fused", params=jp, lr=1e-3)
    progs = programs.build_programs(cfg, GBAConfig(**gba), params=tp,
                                    mode="fused", lr=1e-3, workers=4)
    stream = make_lm_stream(cfg.vocab_size, S, 2, seed=0)
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for i in range(8):
        b = stream.batch(i)
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(i // M, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, i // M)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    lay = progs.layout
    for got, want in zip(lay.leaves(ts["params"]),
                         jax.tree.leaves(js["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    for got, want in zip(lay.leaves(lay.unravel(ts["accum"], torch.float32)),
                         jax.tree.leaves(jprogs.layout.unravel(js["accum"]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_wire_step_for_switches_at_the_warmup():
    cfg = get_config("granite-8b").reduced()
    params = _granite_tree()
    for scheme, want in (("none", ["w", "w", "w"]),
                         ("int8", ["w", "w", "c"])):
        progs = programs.build_programs(
            cfg, GBAConfig(local_batch=4, buffer_size=4), params=params,
            mode="wire", workers=4,
            compress=CompressionPolicy(scheme=scheme, warmup_steps=2))
        got = ["w" if progs.wire_step_for(i) is progs.warm_step else "c"
               for i in range(3)]
        assert got == want
        assert (progs.warm_step is progs.compressed_step) == (
            scheme == "none")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _reference_lines(workers: int) -> list[str]:
    """What the reference launcher prints for its sharded fused step
    (``repro/launch/train.py``), from the reference's own layout."""
    jp = JT.init_model(jax.random.PRNGKey(0),
                       jax_get_config("granite-8b").reduced())
    lay = JaxLayout.from_params(jp, workers, 2048,
                                group_by=JT.param_group_key)
    table = ", ".join(f"{r['key']}={r['bytes'] / 1e6:.2f}MB"
                      for r in lay.group_table())
    return [f"sharded fused gba_apply path (Adagrad): flat buffer (4, "
            f"{lay.padded_total}) sliced over data={lay.num_shards} "
            f"(shard_size={lay.shard_size}, tile={lay.tile}; 1 apply "
            f"launch/shard vs {len(lay.sizes)} per-leaf)",
            f"layer groups ({lay.num_groups}): {table}; peak_gather="
            f"{lay.peak_gather_bytes / 1e6:.2f}MB vs full_gather="
            f"{lay.full_gather_bytes / 1e6:.2f}MB"]


def _losses(out: str) -> list[str]:
    return [" ".join(line.split()[:4]) for line in out.splitlines()
            if line.startswith("step ")]


def test_cli_mesh_compress_none_runs_the_sharded_fused_step(capsys):
    """``--fused --mesh 2x1 --compress none`` runs the sharded fused step,
    not the wire step: the reference's lines, 2 launches a global step,
    and the single-device step's losses."""
    args = ["--arch", "granite-8b", "--reduced", "--fused", "--steps", "8",
            "--seq", "32", "--device", "cpu"]
    calls = ops.kernel_calls["gba_apply_flat"]
    train.main(args + ["--mesh", "2x1", "--compress", "none"])
    out = capsys.readouterr().out
    assert ops.kernel_calls["gba_apply_flat"] - calls == 4
    lines = out.splitlines()
    for want in _reference_lines(2):
        assert want in lines, (want, out)
    assert "quantized wire" not in out
    train.main(args)
    single = capsys.readouterr().out
    assert "fused gba_apply path (Adagrad): flat buffer (4, 918272)" in single
    assert _losses(out) == _losses(single) and len(_losses(out)) == 3
    train.main(args + ["--mesh", "2x1", "--layer-groups", "off"])
    flat = capsys.readouterr().out
    assert "sliced over data=2" in flat and "layer groups" not in flat
