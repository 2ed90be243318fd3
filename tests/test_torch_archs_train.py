"""Training the attention-family architectures of the port on the CPU
against the JAX package: gemma2-27b, gemma3-12b, starcoder2-3b,
phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b at ``.reduced()``, with 80 tokens
a sequence, past the reduced window of 64, so the window's mask binds.

For each architecture: the gradient of ``lm_loss`` against ``jax.grad``
of the reference's in float32 and bfloat16, and the pytree GBA step over
8 microsteps at M = 4 (Adam; Adagrad for kimi-k2, as ``ARCH_OPTIMIZER``
gives it) against the reference's ``build_programs(mode="pytree")``.
Then kimi-k2's list of prefix layers through the flat and the
layer-grouped layouts, and the launcher's pytree step for the five.  The
fused step is held in ``tests/test_torch_archs_fused.py``, with this
file's fixtures, so that the two halves run on two of the suite's
workers.

Parameters are drawn by the port's ``init_model`` and carried to the
reference as jax arrays; batches come from the numpy LM stream, the same
in both packages.  The reference's steps run jitted, outside any mesh,
with its module-global activation sharding cleared.

MoE routes.  A ``top_k`` choice flips where two router probabilities are
within the two packages' rounding of each other.  The gradient tests hold
the MoE layers' ``sel``, ``slot`` and ``keep`` exactly against the
reference's own routing inside its compiled gradient (the spy of
``tests/test_torch_archs.py``) at parameter seed 6, the seed at which
that file holds both dtypes' routes.  The steps run in float32 and hold
every route of the port above a margin of 1e-4 between a token's K-th
and (K+1)-th probability, a hundred times the float32 difference of the
two packages' probabilities.

Tolerances, with their reasons (the measured worst beside each):
* gradients: ``tests/test_torch_lm.py``'s ``TOL``, each leaf within 1e-5
  (float32; 2.3e-6) or 2**-5 (bfloat16; 0.023) of its largest magnitude;
* the pytree step: losses within rtol 1e-6 (2.1e-7); ``micro``,
  ``gstep`` and the optimizer's count exact; params within atol 2.5e-4,
  a quarter of lr (1.8e-4), with at most 1 element in 1,000 of the tree
  beyond rtol 1e-5 / atol 1e-7 (4.8e-4 of gemma2-27b's); the optimizer's
  state within 1e-3 of its leaf's largest magnitude (1.2e-4).  Adam moves
  an element by about lr whatever the size of its gradient, so where a
  gradient is near Adam's epsilon, or two microsteps' gradients nearly
  cancel, their last bits move the update by a part of lr; the second
  global step's gradients, and so the moments, are then taken at params
  that differ by that much.  granite-8b's 32-token batches left fewer
  such elements than these 80-token ones;
* kimi-k2's layouts: exact (host integers, and the ravel is data
  movement).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.core.flat_sharded import ShardedFlatLayout as JaxShardedLayout
from repro.core.flat_sharded import path_names
from repro.core.gba import FlatLayout as JaxFlatLayout
from repro.launch.programs import build_programs as jax_build_programs
from repro.models import transformer as JT
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.core.flat_sharded import TILE, ShardedFlatLayout
from repro_torch.core.gba import FlatLayout, path_unflatten, tree_paths
from repro_torch.data import make_lm_stream
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.programs import ARCH_OPTIMIZER, build_programs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from test_torch_archs import _jax_route_arrays, _route_record

ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
         "kimi-k2-1t-a32b")
KIMI = "kimi-k2-1t-a32b"
B, S, M, IOTA, LR = 2, 80, 4, 4, 1e-3
SEED = 6                      # no near-tie at an MoE layer (see above)
TOL = {  # dtype -> (grads, step loss rtol), tests/test_torch_lm.py's
    "float32": (1e-5, 1e-6),
    "bfloat16": (2.0**-5, 5e-4),
}
MARGIN = 1e-4
# the launcher's tokens i // M, but microstep 5's is -5: 6 steps old at the
# second apply, which Eq. (1) drops at iota 4
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


@pytest.fixture(scope="module")
def models():
    """``models(arch, dtype)``: both packages' ``.reduced()`` configs and
    the port's parameters from seed 6 with the same values as jax arrays,
    drawn once a module."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                       dtype=dtype)
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=dtype)
            p = T.init_model(cfg,
                             generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
            cache[arch, dtype] = (jcfg, cfg, p)
        jcfg, cfg, p = cache[arch, dtype]
        jp = jax.tree.map(
            lambda t: jnp.asarray(t.float().numpy(), dtype=_JDT[t.dtype]), p)
        return jcfg, cfg, jp, T._map(p, torch.clone)

    return get


def _close_to_max(got, want, frac, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _margins(monkeypatch) -> list:
    """Record the least margin between a token's K-th and (K+1)-th router
    probability of every route the port's MoE layers take."""
    seen, route = [], L.moe_route

    def spy(p, cfg, xt):
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.experts_per_token
        seen.append((top[:, k - 1] - top[:, k]).min().item())
        return route(p, cfg, xt)

    monkeypatch.setattr(L, "moe_route", spy)
    return seen


def _stream(cfg):
    stream = make_lm_stream(cfg.vocab_size, S, B, seed=0)
    return [stream.batch(i) for i in range(len(TOKENS))]


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, dtype, models, monkeypatch):
    """Every leaf's gradient of ``lm_loss`` (the aux term included)
    against ``jax.grad`` of the reference's, in the reference's flat
    order, after the MoE routes are held equal."""
    jcfg, cfg, jp, p = models(arch, dtype)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seen = {"jax": [], "port": []}
    jax_moe, port_route = JL.moe_fwd, L.moe_route

    def jax_spy(p, cfg, x):
        jax.debug.callback(
            lambda *a: seen["jax"].append(
                _route_record(cfg.experts_per_token, *a)),
            *_jax_route_arrays(p, cfg, x), ordered=True)
        return jax_moe(p, cfg, x)

    def port_spy(p, cfg, xt):
        seen["port"].append(port_route(p, cfg, xt))
        return seen["port"][-1]

    monkeypatch.setattr(JL, "moe_fwd", jax_spy)
    monkeypatch.setattr(L, "moe_route", port_spy)
    jgrads = jax.jit(jax.grad(lambda jp, t, y: JT.lm_loss(jp, jcfg, t, y)))(
        jp, jnp.asarray(toks), jnp.asarray(labels))
    jax.effects_barrier()
    paths, leaves = zip(*tree_paths(p))
    live = [x.detach().requires_grad_() for x in leaves]
    loss = T.lm_loss(path_unflatten(paths, live), cfg, torch.from_numpy(toks),
                     torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, live)

    n_moe = sum(map(T._is_moe, (*cfg.prefix_layers,
                                *cfg.block_pattern * cfg.num_repeats)))
    assert len(seen["jax"]) == len(seen["port"]) == n_moe
    for want, got in zip(seen["jax"], seen["port"]):
        assert want["margin"] > MARGIN, "a near-tie"
        for k in ("sel", "slot", "keep"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [path_names(k) for k, _ in flat] == list(paths)
    for path, x, g, (_, want) in zip(paths, live, grads, flat):
        assert g.dtype == x.dtype, path
        assert str(want.dtype) == str(x.dtype).removeprefix("torch."), path
        _close_to_max(g.float().numpy(), want, TOL[dtype][0], "/".join(path))


# ---------------------------------------------------------------------------
# the pytree and fused GBA steps
# ---------------------------------------------------------------------------

def _optimizer_name(arch):
    return ARCH_OPTIMIZER.get(arch, "adam")


@pytest.mark.parametrize("arch", ARCHS)
def test_pytree_step_matches_jax_over_8_microsteps(arch, models,
                                                   monkeypatch):
    """8 microsteps of ``build_programs(mode="pytree")`` at M = 4 with the
    arch's optimizer at lr 1e-3 and float32 accumulators in both
    packages, microstep 5's token stale beyond iota."""
    jcfg, cfg, jp, p = models(arch, "float32")
    name = _optimizer_name(arch)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="pytree",
                               params=jp, optimizer=jax_get_optimizer(
                                   name, LR))
    progs = build_programs(cfg, GBAConfig(**gba), params=p, mode="pytree",
                           optimizer=get_optimizer(name, LR))
    assert progs.optimizer.name == jprogs.optimizer.name == name
    margins = _margins(monkeypatch)
    js, ts, jl, tl = jprogs.state, progs.state, [], []
    for b, token in zip(_stream(cfg), TOKENS):
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
        ts, loss = progs.step(ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        tl.append(loss.item())
    assert min(margins, default=1.0) > MARGIN
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=TOL["float32"][1])
    assert (ts["micro"], ts["gstep"]) == (int(js["micro"]),
                                          int(js["gstep"])) == (8, 2)
    state_names = ("accum",) if name == "adagrad" else ("m", "v")
    if name == "adam":
        assert int(ts["opt"]["count"]) == int(js["opt"]["count"]) == 2
    layout = FlatLayout.from_params(p)
    trees = [("acc", js["acc"], ts["acc"])] + [
        (k, js["opt"][k], ts["opt"][k]) for k in state_names]
    for what, jtree, ttree in trees:
        for path, got, want in zip(layout.paths, layout.leaves(ttree),
                                   jax.tree.leaves(jtree)):
            _close_to_max(got.numpy(), want, 1e-3, f"{what} {path}")
    beyond = 0
    for path, got, want in zip(layout.paths, layout.leaves(ts["params"]),
                               jax.tree.leaves(js["params"])):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, rtol=0, atol=LR / 4,
                                   err_msg="/".join(path))
        beyond += int((np.abs(got - want) > 1e-5 * np.abs(want) + 1e-7).sum())
    assert beyond <= layout.total / 1000, beyond


# ---------------------------------------------------------------------------
# kimi-k2: a list of prefix layers through the layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kimi_flat_ravel_matches_the_reference_element_for_element(
        dtype, models):
    _, _, jp, p = models(KIMI, dtype)
    assert isinstance(p["prefix"], list) and len(p["prefix"]) == 1
    layout, ref = FlatLayout.from_params(p), JaxFlatLayout.from_params(jp)
    assert layout.paths == tuple(
        path_names(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0])
    assert ("prefix", "#0", "attn", "wq") in layout.paths
    assert (layout.sizes, layout.offsets, layout.total) == (
        ref.sizes, ref.offsets, ref.total)
    flat = layout.ravel(p)
    np.testing.assert_array_equal(flat.numpy().view(np.uint32),
                                  np.asarray(ref.ravel(jp)).view(np.uint32))
    back = layout.unravel(flat)
    assert isinstance(back["prefix"], list)
    for a, b in zip(layout.leaves(back), layout.leaves(p)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shards", [2, 4])
def test_kimi_layer_groups_match_the_reference(shards, models):
    """``param_group_key`` names each leaf's group as the reference's
    does (``prefix.#0`` for the dense prefix layer), and the layer-grouped
    layout has the reference's groups, in its order, at its extents."""
    _, _, jp, p = models(KIMI, "float32")
    for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = path_names(path)
        assert T.param_group_key(names) == JT.param_group_key(names)
    assert T.param_group_key(()) == JT.param_group_key(()) == "misc"
    lay = ShardedFlatLayout.from_params(p, shards, TILE,
                                        group_by=T.param_group_key)
    ref = JaxShardedLayout.from_params(jp, shards, TILE,
                                       group_by=JT.param_group_key)
    assert lay.group_keys == ref.group_keys == (
        "blocks.l0", "embed", "final_norm", "head", "prefix.#0")
    for name in ("leaf_group", "group_sizes", "group_shard_sizes",
                 "group_local_offsets", "offsets", "sizes", "padded_sizes",
                 "padded_total", "shard_size"):
        assert getattr(lay, name) == getattr(ref, name), name
    assert [r["key"] for r in lay.group_table()] == list(ref.group_keys)


# ---------------------------------------------------------------------------
# build_programs and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_check_trainable_and_the_archs_optimizer(arch):
    """The five train; the optimizer comes from the arch's own name
    (Adagrad for kimi-k2, Adam for the rest), which ``.reduced()``
    renames, so the launcher resolves it before."""
    full = get_config(arch)
    T.check_supported(full)
    T.check_supported(full.reduced())
    assert _optimizer_name(full.name) == (
        "adagrad" if arch == KIMI else "adam")
    assert full.reduced().name not in ARCH_OPTIMIZER


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_pytree_step_on_the_cpu(arch, capsys):
    """``launch.train --arch X --reduced`` runs the pytree step with the
    arch's optimizer: 8 finite losses and two global steps, no
    ``gba_apply``."""
    calls = ops.kernel_calls["gba_apply_flat"]
    losses = train.main(["--arch", arch, "--reduced", "--steps", "8",
                         "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert ops.kernel_calls["gba_apply_flat"] == calls
    assert f"pytree GBA path ({_optimizer_name(arch)}): M=4, iota=4" in out
    assert "gstep 2" in out.strip().splitlines()[-1]
