"""The switching harness on the LM, on the CPU: the port's pytree sync
step (``make_gba_psum_step``, ``build_programs(mode="sync_psum")``) and
``repro_torch.launch.train --autoswitch``, against the JAX package's.

* The sync step at ``granite-8b.reduced()`` in float32, 4 workers, 2
  global steps (the second with one Eq. (1)-decayed slot and one
  tombstone slot): the reference runs ``build_programs(mode="sync_psum")``
  on a forced 4-device CPU mesh in a subprocess, from the same params and
  batches; params and accumulator within 1e-6, losses within rtol 1e-6
  (float32 sums in other orders).  The same step on 2 gloo ranks
  (``world=``, 2 workers a rank, summed in worker order through the
  chain) within 1e-5 of the reference on every rank.
* The launcher: ``python -m repro.launch.train --arch granite-8b
  --reduced --mesh 4x1 --host-devices 4 --autoswitch --plan strained
  --batches 120`` and the port's ``train.main`` with the same arguments
  print the same summary, number for number, but the final loss, which
  depends on the initial weights; the port's ``run_autoswitch`` from the
  reference's initial weights ends within 1e-4 of the reference's final
  loss.
"""
import contextlib
import dataclasses
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.gba import aggregate_dense, tree_paths
from repro_torch.core.gba_shard_map import make_gba_psum_step
from repro_torch.data import make_lm_stream
from repro_torch.distributed import process_group, selfcheck
from repro_torch.launch import train
from repro_torch.launch.programs import (build_programs, loss_and_grads,
                                         make_loss_fn)
from repro_torch.optim import sgd, tree_map

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
W, B, S, IOTA, LR = 4, 2, 32, 4, 0.05
# (gstep, tokens, zero slots): slot 1 of gstep 5 is 5 > iota steps stale,
# slot 2 a tombstone (token gstep - iota - 1, zero batch)
STEPS = ((0, (0, 0, 0, 0), ()), (5, (5, 0, 0, 5), (2,)))

_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import GBAConfig
from repro.launch.programs import build_programs

inp = dict(np.load(sys.argv[1]))
cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                          dtype="float32")
params = {}
for k, v in inp.items():
    if k.startswith("p/"):
        node = params
        *head, last = k[2:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
mesh = jax.make_mesh((4,), ("data",))
progs = build_programs(cfg, GBAConfig(local_batch=2, buffer_size=4,
                                      staleness_tolerance=4),
                       mode="sync_psum", mesh=mesh, params=params, lr=0.05)
shd = NamedSharding(mesh, P("data"))
params, opt = progs.state["params"], progs.state["opt"]
out = {}
for i in range(int(inp["steps"])):
    batch = jax.device_put({"tokens": jnp.asarray(inp[f"tokens{i}"]),
                            "labels": jnp.asarray(inp[f"labels{i}"])}, shd)
    toks = jax.device_put(jnp.asarray(inp[f"toks{i}"]), shd)
    params, opt, loss = progs.step(params, opt, batch, toks,
                                   jnp.int32(inp[f"gstep{i}"]))
    out[f"loss{i}"] = np.asarray(loss)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
for path, leaf in jax.tree_util.tree_flatten_with_path(opt["accum"])[0]:
    out["a/" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("granite-8b").reduced(),
                               dtype="float32")
    return jcfg, dataclasses.replace(get_config("granite-8b").reduced(),
                                     dtype="float32")


def _inputs():
    """The params (numpy, by path) and per-step batches and tokens."""
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg))
    stream = make_lm_stream(cfg.vocab_size, S, W * B, seed=0)
    inp = {"steps": np.int32(len(STEPS))}
    for path, leaf in tree_paths(jp):
        inp["p/" + "/".join(path)] = leaf
    for i, (gstep, toks, zero) in enumerate(STEPS):
        b = stream.batch(i)
        for k in ("tokens", "labels"):
            v = b[k].copy()
            for s in zero:
                v[s * B:(s + 1) * B] = 0
            inp[f"{k}{i}"] = v
        inp[f"toks{i}"] = np.int32(toks)
        inp[f"gstep{i}"] = np.int32(gstep)
    return jp, inp


@pytest.fixture(scope="module")
def sync_step_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync")
    jp, inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=ENV, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return jp, inp, dict(np.load(tmp / "out.npz"))


def _port_steps(jp, inp):
    _, cfg = _cfgs()
    progs = build_programs(cfg, GBAConfig(local_batch=B, buffer_size=W,
                                          staleness_tolerance=IOTA),
                           params=params_from_jax(jp, device="cpu"),
                           mode="sync_psum", lr=LR, workers=W)
    step, params, opt = (progs.step, progs.state["params"],
                         progs.state["opt"])
    losses = []
    for i in range(len(STEPS)):
        batch = {k: torch.from_numpy(inp[f"{k}{i}"])
                 for k in ("tokens", "labels")}
        params, opt, loss = step(params, opt, batch,
                                 torch.from_numpy(inp[f"toks{i}"]),
                                 int(inp[f"gstep{i}"]))
        losses.append(loss.item())
    return params, opt, losses


def test_sync_psum_step_matches_the_reference(sync_step_run):
    jp, inp, ref = sync_step_run
    params, opt, losses = _port_steps(jp, inp)
    np.testing.assert_allclose(
        losses, [ref[f"loss{i}"] for i in range(len(STEPS))], rtol=1e-6)
    for prefix, tree in (("p/", params), ("a/", opt["accum"])):
        for path, leaf in tree_paths(tree):
            want = ref[prefix + "/".join(path)]
            assert leaf.dtype == torch.float32
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0,
                                       atol=1e-6, err_msg=str(path))


def test_sync_psum_step_on_two_gloo_ranks_matches_the_reference(
        sync_step_run, tmp_path):
    """``build_programs(mode="sync_psum", world=)`` on 2 gloo ranks of 2
    workers each, every rank taking its workers' rows: each rank's params,
    accumulator and losses within 1e-5 of the reference's psum step on a
    forced 4-device mesh."""
    _, inp, ref = sync_step_run
    _, cfg = _cfgs()
    gba = GBAConfig(local_batch=B, buffer_size=W, staleness_tolerance=IOTA)
    process_group.spawn(selfcheck.run_lm_psum, 2, cfg, inp, gba, LR,
                        str(tmp_path), device="cpu", timeout=240.0)
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert set(got) == set(ref)
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5,
                                       err_msg=f"rank {r}: {k}")


def test_sync_psum_step_is_the_decayed_aggregate():
    """With SGD the step is ``aggregate_dense`` of the workers' gradients
    followed by SGD: the tombstone and the stale slot weigh nothing."""
    _, cfg = _cfgs()
    jp, inp = _inputs()
    params = params_from_jax(jp, device="cpu")
    gstep, toks, _ = STEPS[1]
    batch = {k: torch.from_numpy(inp[f"{k}1"]) for k in ("tokens", "labels")}
    step = make_gba_psum_step(W, make_loss_fn(cfg), sgd(LR), IOTA)
    got, _, _ = step(params, {}, batch, torch.tensor(toks, dtype=torch.int32),
                     gstep)
    grads = [loss_and_grads(cfg, params, {k: v[w * B:(w + 1) * B]
                                          for k, v in batch.items()})[1]
             for w in range(W)]
    stacked = tree_map(lambda *g: torch.stack(g), *grads)
    agg = aggregate_dense(stacked, torch.tensor(toks, dtype=torch.int32),
                          gstep, IOTA)
    want, _ = sgd(LR).update(params, agg, {})
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=str(path))


def test_build_programs_rejects_an_unknown_mode():
    _, cfg = _cfgs()
    params = params_from_jax(jax.tree.map(np.asarray, JT.init_model(
        jax.random.PRNGKey(0), _cfgs()[0])), device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        build_programs(cfg, GBAConfig(), params=params, mode="sharded")
    with pytest.raises(ValueError, match="workers"):
        build_programs(cfg, GBAConfig(), params=params, mode="sync_psum",
                       workers=0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_LINE = re.compile(r"^autoswitch \(strained\): (.*), final loss ([0-9.]+)$",
                   re.MULTILINE)
_AUTOSWITCH = ["--arch", "granite-8b", "--reduced", "--mesh", "4x1",
               "--autoswitch", "--plan", "strained", "--batches", "120"]


@pytest.fixture(scope="module")
def launcher_runs():
    """The reference launcher (a subprocess), then the port's CLI and the
    port's ``run_autoswitch`` from the reference's weights, in this
    process; one after another, since the JAX and PyTorch thread pools
    slow each other down many times over when they share the cores."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *_AUTOSWITCH,
         "--host-devices", "4"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main([*_AUTOSWITCH, "--device", "cpu"])
    jcfg = jax_get_config("granite-8b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, JT.init_model(
        jax.random.PRNGKey(0), jcfg)), device="cpu")
    res = train.run_autoswitch(get_config("granite-8b").reduced(),
                               workers=4, plan="strained", batches=120,
                               device="cpu", params=params)
    return _LINE.search(ref.stdout), _LINE.search(out.getvalue()), res


def test_launcher_prints_the_reference_numbers(launcher_runs):
    ref, port, _ = launcher_runs
    assert ref and port
    assert port.group(1) == ref.group(1)
    assert port.group(1) == (
        "30 global steps, 1 switch(es), mode steps {'sync': 4, 'gba': 26}, "
        "first switch at gstep 4, sim qps 6,619, crashes 0 rejoins 0 "
        "timeouts 0, swaps verified 1")


def test_launcher_from_the_reference_weights_ends_at_its_loss(
        launcher_runs):
    ref, _, res = launcher_runs
    assert math.isclose(res.losses[-1], float(ref.group(2)), rel_tol=1e-4)
    assert res.swaps_verified == 1 and res.switch_count == 1


@pytest.mark.parametrize("mesh", ["", "1x1", "1x2"])
def test_autoswitch_needs_two_or_more_workers(mesh, capsys):
    args = ["--arch", "granite-8b", "--reduced", "--autoswitch",
            "--device", "cpu"] + (["--mesh", mesh] if mesh else [])
    with pytest.raises(SystemExit) as exit_:
        train.main(args)
    assert exit_.value.code != 0
    assert "--autoswitch needs --mesh" in capsys.readouterr().err
