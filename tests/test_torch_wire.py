"""The port's worker-parallel wire step against the JAX package's, on the
CPU.

The reference's ``make_gba_fused_psum_step`` and its launcher's wire
program need a 4-device mesh, so they run in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; arrays cross
through npz files.  Both sides start from the same numpy parameters and
batches.

The step tests use the tree of ``tests/test_quantized_wire.py``'s wire
script: 3 layer groups, leaves that are not tile multiples, tile 256, 4
workers and shards, worker 2 three steps stale (Eq. (1) drops it at iota
2), 3 global steps.  The loss is ``mean(x) * sum of squares`` with ``x``
in multiples of 1/8, so the mean is exact, and the sums of squares are
folded in halves, element by element, in both frameworks, so the loss
takes one order of additions in both.  The gradients are then bit-exact,
and so are params, accumulator, loss and residual for ``none``, the
float32 warmup and int8.  onebit is held within a tolerance, for two
reasons: the sign scale is XLA's mean of |x| in its own reduction order,
within 2 ulps of the port's fixed-order float64 sum
(``tests/test_torch_quantize.py``); and XLA computes the momentum EMA
``beta * m + (1 - beta) * g`` as one fused multiply-add, where the port
rounds the product and the sum.

The launcher tests run ``granite-8b.reduced()`` through the port's
``run_wire_train`` and the reference's ``build_programs(mode="wire")``
loop, 4 workers, 2 warmup and 2 compressed global steps, from the JAX
package's initial parameters.
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
from repro.core.compression import CompressionPolicy as JaxPolicy
from repro.core.flat_sharded import ShardedFlatLayout as JaxLayout
from repro.core.flat_sharded import path_names
from repro.core.staleness import threshold_decay as jax_threshold_decay
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.compression import MOMENTUM, CompressionPolicy
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import tree_paths
from repro_torch.core.gba_shard_map import make_gba_fused_psum_step
from repro_torch.core.staleness import threshold_decay
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
M, TILE, IOTA, LR, STEPS = 4, 256, 2, 0.05, 3
JCFG = jax_get_config("granite-8b")
# name -> (scheme, warm)
CASES = {"none": ("none", False), "int8_warm": ("int8", True),
         "onebit_warm": ("onebit", True), "int8": ("int8", False),
         "onebit": ("onebit", False)}
# onebit (the momentum; and params, accumulator and residual past the
# warmup): the EMA differs by one rounding a step and the sign scale by up
# to 2 ulps (4 allowed, as for the kernel), which moves each routed value
# by as many ulps of the scale and each Adagrad update by as many of the
# update.  Over 3 steps on values of order 1 that stays within 1e-6
# absolute plus 32 ulps relative.
ONEBIT_RTOL = 32 * 2.0**-23
ONEBIT_ATOL = 1e-6

_STEP_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.compression import CompressionPolicy
from repro.core.flat_sharded import ShardedFlatLayout
from repro.core.gba_shard_map import make_gba_fused_psum_step

inp = dict(np.load(sys.argv[1]))
params = jax.tree.map(jnp.asarray, {
    "embed": inp["embed"], "head": inp["head"],
    "blocks": {"l0": {"w": inp["w"], "b": inp["b"]}}})
mesh = jax.make_mesh((4,), ("data",))
lay = ShardedFlatLayout.from_params(params, 4, tile=256,
                                    group_by=lambda n: n[0])

def fold(v):
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = jnp.concatenate([v, jnp.zeros((n - v.shape[0],), v.dtype)])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]

def loss_fn(p, batch):
    s = None
    for leaf in jax.tree.leaves(p):
        f = leaf.astype(jnp.float32).reshape(-1)
        s = fold(f * f) if s is None else s + fold(f * f)
    return jnp.mean(batch["x"]) * s

out = {}
for name, scheme, warm in [l.split(":") for l in sys.argv[3].split(",")]:
    warm = warm == "1"
    pol = CompressionPolicy(scheme=scheme, warmup_steps=10 if warm else 0)
    step = jax.jit(make_gba_fused_psum_step(
        mesh, loss_fn, lay, iota=2, lr=0.05, compress=pol, warm=warm))
    pf = lay.ravel(params)
    af = jnp.full((lay.padded_total,), 0.1, jnp.float32)
    wire = pol.init_wire_state(lay, 4) if pol.stateful else None
    losses = []
    with mesh:
        for t in range(3):
            batch = jax.device_put({"x": jnp.asarray(inp["x"][t])},
                                   NamedSharding(mesh, P("data")))
            toks = jax.device_put(jnp.array([t, t, t - 3, t], jnp.int32),
                                  NamedSharding(mesh, P("data")))
            if wire is None:
                pf, af, loss = step(pf, af, batch, toks, jnp.int32(t))
            else:
                pf, af, loss, wire = step(pf, af, batch, toks,
                                          jnp.int32(t), wire)
            losses.append(np.asarray(loss))
    out[name + "/param"] = np.asarray(pf)
    out[name + "/accum"] = np.asarray(af)
    out[name + "/loss"] = np.stack(losses)
    for k, v in (wire or {}).items():
        out[name + "/" + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _jax(script: str, tmp: Path, inputs: dict, *args: str) -> dict:
    np.savez(tmp / "in.npz", **inputs)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp / "in.npz"),
         str(tmp / "out.npz"), *args], env=ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _tree(inp: dict) -> dict:
    return {"embed": torch.from_numpy(inp["embed"]),
            "head": torch.from_numpy(inp["head"]),
            "blocks": {"l0": {"w": torch.from_numpy(inp["w"]),
                              "b": torch.from_numpy(inp["b"])}}}


def _fold(v: torch.Tensor) -> torch.Tensor:
    n = 1
    while n < v.shape[0]:
        n *= 2
    v = torch.cat([v, v.new_zeros(n - v.shape[0])])
    while n > 1:
        n //= 2
        v = v[:n] + v[n:]
    return v[0]


def _loss(p, batch):
    s = None
    for _, leaf in tree_paths(p):
        f = leaf.float().reshape(-1)
        s = _fold(f * f) if s is None else s + _fold(f * f)
    return batch["x"].mean() * s


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    rng = np.random.default_rng(7)
    inp = {"embed": rng.standard_normal((33, 9)),
           "w": rng.standard_normal((41,)), "b": rng.standard_normal((7, 5)),
           "head": rng.standard_normal((700,)),
           "x": rng.integers(1, 17, (STEPS, 32)) * rng.choice(
               [-1.0, 1.0], (STEPS, 32)) / 8}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    cases = ",".join(f"{n}:{s}:{int(w)}" for n, (s, w) in CASES.items())
    return inp, _jax(_STEP_SCRIPT, tmp_path_factory.mktemp("step"), inp,
                     cases)


def _port_run(inp: dict, scheme: str, warm: bool):
    params = _tree(inp)
    lay = ShardedFlatLayout.from_params(params, M, tile=TILE,
                                        group_by=lambda n: n[0])
    pol = CompressionPolicy(scheme=scheme, warmup_steps=10 if warm else 0)
    step = make_gba_fused_psum_step(M, _loss, lay, iota=IOTA, lr=LR,
                                    compress=pol, warm=warm)
    pf = lay.ravel(params)
    af = torch.full((lay.padded_total,), 0.1)
    wire = pol.init_wire_state(lay, M, "cpu") if pol.stateful else None
    losses = []
    for t in range(STEPS):
        batch = {"x": torch.from_numpy(inp["x"][t])}
        toks = torch.tensor([t, t, t - 3, t], dtype=torch.int32)
        out = step(pf, af, batch, toks, t, *([wire] if wire else []))
        assert out[0] is pf and out[1] is af        # updated in place
        losses.append(out[2].item())
    return lay, pf, af, np.float32(losses), wire


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_wire_step_matches_the_jax_step(step_run, name):
    inp, ref = step_run
    scheme, warm = CASES[name]
    calls = dict(ops.kernel_calls)
    lay, pf, af, losses, wire = _port_run(inp, scheme, warm)
    assert lay.group_keys == ("blocks", "embed", "head")
    got = {"param": pf.numpy(), "accum": af.numpy(), "loss": losses,
           **{k: v.numpy() for k, v in (wire or {}).items()}}
    assert sorted(got) == sorted(k.split("/")[1] for k in ref
                                 if k.startswith(name + "/"))
    quantized = scheme != "none" and not warm
    # per global step: one quantize per worker and group, one dequantize
    # per shard and group, one apply per shard
    n = STEPS * M * lay.num_groups if quantized else 0
    assert ops.kernel_calls["quantize_wire"] - calls.get(
        "quantize_wire", 0) == n
    assert ops.kernel_calls["dequantize_wire"] - calls.get(
        "dequantize_wire", 0) == n
    assert ops.kernel_calls["gba_apply_flat"] - calls.get(
        "gba_apply_flat", 0) == STEPS * M
    for k, v in got.items():
        want = ref[f"{name}/{k}"]
        assert v.shape == want.shape, k
        if scheme == "onebit" and (k == "momentum" or not warm):
            np.testing.assert_allclose(v, want, rtol=ONEBIT_RTOL,
                                       atol=ONEBIT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(_bits(v), _bits(want), err_msg=k)
    if warm:
        assert not wire["residual"].any()
    if scheme == "onebit":
        assert wire["momentum"].abs().max() > 0


def test_warmup_is_bit_identical_to_the_uncompressed_step(step_run):
    inp, _ = step_run
    _, pf, af, losses, _ = _port_run(inp, "none", False)
    for scheme in ("int8", "onebit"):
        _, wp, wa, wl, wire = _port_run(inp, scheme, True)
        assert torch.equal(wp.view(torch.int32), pf.view(torch.int32))
        assert torch.equal(wa.view(torch.int32), af.view(torch.int32))
        np.testing.assert_array_equal(_bits(wl), _bits(losses))


def test_grouped_and_ungrouped_layouts_train_alike(step_run):
    """Uncompressed, the layer grouping changes where each column lives,
    not its value: the unraveled params agree bit for bit."""
    inp, _ = step_run
    out = []
    for group_by in (lambda n: n[0], None):
        params = _tree(inp)
        lay = ShardedFlatLayout.from_params(params, M, tile=TILE,
                                            group_by=group_by)
        step = make_gba_fused_psum_step(M, _loss, lay, iota=IOTA, lr=LR)
        pf, af = lay.ravel(params), torch.full((lay.padded_total,), 0.1)
        for t in range(STEPS):
            step(pf, af, {"x": torch.from_numpy(inp["x"][t])},
                 torch.tensor([t, t, t - 3, t], dtype=torch.int32), t)
        out.append(lay.unravel(pf))
    for (_, a), (_, b) in zip(tree_paths(out[0]), tree_paths(out[1])):
        assert torch.equal(a, b)


def test_step_refuses_mismatched_shapes():
    params = {"w": torch.zeros(10)}
    lay = ShardedFlatLayout.from_params(params, M, tile=TILE)
    with pytest.raises(ValueError, match="shards"):
        make_gba_fused_psum_step(3, _loss, lay, iota=IOTA, lr=LR)
    step = make_gba_fused_psum_step(M, _loss, lay, iota=IOTA, lr=LR)
    pf, af = lay.ravel(params), torch.full((lay.padded_total,), 0.1)
    toks = torch.zeros(M, dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        step(pf, af, {"x": torch.ones(6)}, toks, 0)
    with pytest.raises(ValueError, match="tokens"):
        step(pf, af, {"x": torch.ones(8)}, toks[:3], 0)
    with pytest.raises(ValueError, match="param_flat"):
        step(pf[:-1], af, {"x": torch.ones(8)}, toks, 0)


# ---------------------------------------------------------------------------
# the layout, the policy and the decay against the reference
# ---------------------------------------------------------------------------

def _layout_trees(kind: str):
    """(numpy tree, tile, reference group_by, port group_by)."""
    if kind == "wire_script":
        rng = np.random.default_rng(3)
        tree = {"embed": rng.standard_normal((33, 9)),
                "blocks": {"l0": {"w": rng.standard_normal((41,)),
                                  "b": rng.standard_normal((7, 5))}},
                "head": rng.standard_normal((700,))}
        tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
        return tree, TILE, (lambda n: n[0]), (lambda n: n[0])
    jcfg = JCFG.reduced()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    return tree, 2048, JT.param_group_key, T.param_group_key


LAYOUT_FIELDS = ("shapes", "sizes", "padded_sizes", "offsets", "total",
                 "padded_total", "num_shards", "shard_size", "tile",
                 "group_keys", "leaf_group", "group_sizes",
                 "group_shard_sizes", "group_local_offsets")


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("kind", ["wire_script", "granite"])
def test_sharded_layout_matches_the_reference(kind, grouped):
    tree, tile, jgroup, tgroup = _layout_trees(kind)
    jtree = jax.tree.map(jnp.asarray, tree)
    ref = JaxLayout.from_params(jtree, M, tile=tile,
                                group_by=jgroup if grouped else None)
    params = params_from_jax(tree, device="cpu")
    lay = ShardedFlatLayout.from_params(params, M, tile=tile,
                                        group_by=tgroup if grouped else None)
    for f in LAYOUT_FIELDS:
        assert getattr(lay, f) == getattr(ref, f), f
    assert lay.paths == tuple(path_names(p) for p, _ in
                              jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert [str(d).split(".")[-1] for d in lay.dtypes] == [
        str(d) for d in ref.dtypes]
    assert lay.num_groups == ref.num_groups == (4 if kind == "granite"
                                                and grouped else 3 if
                                                grouped else 1)
    for g in range(lay.num_groups):
        assert lay.group_shard_bounds(g) == ref.group_shard_bounds(g)
        assert lay.group_leaves(g) == ref.group_leaves(g)
    for sh in range(M):
        assert lay.shard_bounds(sh) == ref.shard_bounds(sh)
    with pytest.raises(IndexError):
        lay.group_shard_bounds(lay.num_groups)
    with pytest.raises(IndexError):
        lay.shard_bounds(M)
    # ravel is the reference's, bit for bit, and unravel inverts it
    f32 = jax.tree.map(lambda x: x.astype(np.float32), tree)
    flat = lay.ravel(params_from_jax(f32, device="cpu"))
    want = np.asarray(ref.ravel(jax.tree.map(jnp.asarray, f32)))
    np.testing.assert_array_equal(flat.numpy(), want)
    back = lay.unravel(flat)
    for (path, a), b in zip(tree_paths(back), lay.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    leaves = lay.leaves(params)
    for g in range(lay.num_groups):
        np.testing.assert_array_equal(
            lay.ravel_group(g, leaves).float().numpy(),
            np.asarray(ref.ravel_group(g, jtree)).astype(np.float32))


def test_param_group_key_matches_the_reference():
    jp = JT.init_model(jax.random.PRNGKey(0), JCFG.reduced())
    for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = path_names(path)
        assert T.param_group_key(names) == JT.param_group_key(names)


@pytest.mark.parametrize("scheme", ["none", "int8", "onebit"])
def test_compression_policy_matches_the_reference(scheme):
    tree, tile, jgroup, tgroup = _layout_trees("granite")
    ref_lay = JaxLayout.from_params(jax.tree.map(jnp.asarray, tree), M,
                                    tile=tile, group_by=jgroup)
    lay = ShardedFlatLayout.from_params(params_from_jax(tree, device="cpu"),
                                        M, tile=tile, group_by=tgroup)
    pol, ref = CompressionPolicy(scheme, 2), JaxPolicy(scheme, 2)
    assert pol.stateful == ref.stateful
    assert pol.state_names() == ref.state_names()
    assert pol.sideband_floats_per_tile() == ref.sideband_floats_per_tile()
    assert pol.compression_ratio(lay) == ref.compression_ratio(ref_lay)
    assert pol.wire_dtype() == ref.wire_dtype()
    assert pol.wire_bytes(lay) == ref.wire_bytes(ref_lay)
    state = pol.init_wire_state(lay, M, "cpu")
    want = ref.init_wire_state(ref_lay, M)
    assert {k: (tuple(v.shape), v.dtype, bool(v.any()))
            for k, v in state.items()} == {
        k: (tuple(v.shape), torch.float32, False) for k, v in want.items()}


@pytest.mark.parametrize("bad", [dict(scheme="fp4"), dict(warmup_steps=-1)])
def test_compression_policy_rejects_what_the_reference_rejects(bad):
    for policy in (CompressionPolicy, JaxPolicy):
        with pytest.raises(ValueError):
            policy(**bad)


def test_onebit_momentum_is_the_reference_default():
    assert MOMENTUM == JaxPolicy("onebit").momentum


def test_threshold_decay_matches_the_reference():
    tokens = np.arange(-6, 10, dtype=np.int32)
    for step, iota in ((7, 4), (0, 0), (9, 2)):
        want = np.asarray(jax_threshold_decay(jnp.asarray(tokens),
                                              jnp.int32(step), iota))
        got = threshold_decay(torch.from_numpy(tokens), step, iota)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the launcher: run_wire_train against the reference's wire program
# ---------------------------------------------------------------------------

_TRAIN_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import GBAConfig
from repro.core.compression import CompressionPolicy
from repro.data import make_lm_stream
from repro.launch.programs import build_programs
from repro.models import transformer as T

dtype, schemes = sys.argv[3], sys.argv[4].split(",")
cfg = dataclasses.replace(get_config("granite-8b").reduced(), dtype=dtype)
params = T.init_model(jax.random.PRNGKey(0), cfg)
out = {"param/" + "/".join(str(getattr(k, "key", k)) for k in path):
       np.asarray(leaf, np.float32)
       for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
mesh = jax.make_mesh((4, 1), ("data", "model"))
gba = GBAConfig(local_batch=4, buffer_size=4, staleness_tolerance=4)
stream = make_lm_stream(cfg.vocab_size, 128, 4, seed=0)
for scheme in schemes:
    pol = CompressionPolicy(scheme=scheme, warmup_steps=2)
    with mesh:
        progs = build_programs(cfg, gba, mode="wire", params=params,
                               mesh=mesh, compress=pol, lr=1e-3)
        pf, af = progs.state["param_flat"], progs.state["accum"]
        wire, losses = progs.wire_state, []
        for i in range(4):
            b = stream.batch(i)
            batch = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
            fn = progs.warm_step if i < 2 else progs.compressed_step
            pf, af, loss, wire = fn(pf, af, batch, jnp.full((4,), i, jnp.int32),
                                    jnp.asarray(i, jnp.int32), wire)
            losses.append(float(loss))
    out[scheme + "/loss"] = np.float64(losses)
    out[scheme + "/param"] = np.asarray(pf)
np.savez(sys.argv[2], **out)
"""
# (dtype, warm-phase loss rtol, compressed-phase loss rtol).  float32: the
# warm steps differ by float32 sum orders of the forward and backward (PR
# 14's LM tolerance between the card and the CPU, 1e-5).  Past warmup a
# payload that lies within those differences of a code's rounding boundary
# quantizes one code apart, which moves that routed value by one
# quantization step (1/255 of its tile's range) and that param's Adagrad
# update by at most lr times the step over sqrt(accum): far below 1e-5 of
# the next loss.  bfloat16: PR 14's bf16 step tolerance, 5e-4, for both
# phases.
TRAIN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-4, 5e-4)}


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    runs = {}
    for dtype in TRAIN_TOL:
        runs[dtype] = _jax(_TRAIN_SCRIPT, tmp_path_factory.mktemp(dtype), {},
                           dtype, "int8,onebit")
    return runs


def _jax_params(ref: dict) -> dict:
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith("param/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
    return tree


@pytest.mark.parametrize("dtype", list(TRAIN_TOL))
@pytest.mark.parametrize("scheme", ["int8", "onebit"])
def test_run_wire_train_matches_the_jax_program(train_run, dtype, scheme):
    ref = train_run[dtype]
    cfg = dataclasses.replace(get_config("granite-8b").reduced(), dtype=dtype)
    # the npz carries bfloat16 leaves as float32: back to the model's own
    # leaf dtypes
    like = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")

    def cast(tree, like):
        return {k: cast(v, like[k]) if isinstance(v, dict)
                else v.to(like[k].dtype) for k, v in tree.items()}
    params = cast(params_from_jax(_jax_params(ref), device="cpu"), like)
    seen = []
    losses = train.run_wire_train(
        cfg, workers=M, scheme=scheme, steps=4, compress_warmup=2,
        device="cpu", params=params,
        on_step=lambda i, progs: seen.append(
            (i, progs.layout.group_keys)))
    warm_rtol, comp_rtol = TRAIN_TOL[dtype]
    want = ref[f"{scheme}/loss"]
    np.testing.assert_allclose(losses[:2], want[:2], rtol=warm_rtol)
    np.testing.assert_allclose(losses[2:], want[2:], rtol=comp_rtol)
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert seen[0][1] == ("blocks.l0", "embed", "final_norm", "head")


@pytest.mark.parametrize("scheme,groups,ratio", [
    ("none", "on", "1.000"), ("int8", "on", "0.251"),
    ("onebit", "on", "0.250"), ("int8", "off", "0.251")])
def test_train_cli_runs_the_wire_step_on_the_cpu(scheme, groups, ratio,
                                                 capsys):
    """The launcher's wire step.  ``--compress none`` runs the sharded
    fused step instead (``tests/test_torch_sharded_fused.py``), as the
    reference's launcher does, so the uncompressed wire step is driven
    through ``run_wire_train`` with the command's other settings."""
    if scheme == "none":
        train.run_wire_train(get_config("granite-8b").reduced(), workers=M,
                             scheme=scheme, steps=4, compress_warmup=2,
                             layer_groups=groups == "on", device="cpu")
        out = capsys.readouterr().out
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "granite-8b", "--reduced", "--fused", "--mesh", "4x1",
             "--compress", scheme, "--compress-warmup", "2",
             "--layer-groups", groups, "--steps", "4", "--device", "cpu"],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        out = proc.stdout
    n = 4 if groups == "on" else 1
    assert f"quantized wire ({scheme}): 4 workers x {n} groups" in out
    assert f"(ratio {ratio})" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("step    3"), out


@pytest.mark.parametrize("args,says", [
    (("--mesh", "3x2", "--compress", "int8"), "divide --batch"),
    (("--mesh", "3x1", "--compress", "int8"), "divide --batch"),
    (("--mesh", "1x1", "--ranks", "2"), "2 or more workers"),
    (("--compress", "int8"), "needs --mesh"),
])
def test_train_cli_refuses_what_the_wire_does_not_run(args, says):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-8b", "--reduced", "--fused", *args, "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert says in proc.stderr
