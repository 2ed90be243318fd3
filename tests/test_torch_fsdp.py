"""FSDP of the weights over ``data`` on the sharded fused step
(``launch.train --arch A --fused --mesh WxT``, W > 1) on the CPU.

* ``sharding.place`` with a data index and its inverses
  (``gather_data_shards``, then ``gather_model_shards``) round-trip the
  ten archs' ``.reduced()`` trees bit for bit over 2 x 2 and 4 x 1, each
  block holding the rules' share of the bytes;
* the blocks are the reference's: in one subprocess on a forced 4-device
  CPU mesh, each ``addressable_shards`` block of
  ``jax.device_put(params, to_named(param_specs(...)))`` over 2 x 2
  against the port's block (d, m) of the same draw, carried across with
  ``convert.params_from_jax``, bit for bit (granite-8b, phi3.5-moe,
  mamba2-780m, zamba2-2.7b);
* the FSDP step (``build_programs(mode="fused", workers=W)``, whose
  ``place_state`` is True by default) against ``place_state=False``,
  bit for bit, 2 global steps at M = 4 with one slot stale, in process
  at 2 x 2 and 4 x 1: granite-8b, phi3.5-moe, mamba2-780m (tied
  embeddings), zamba2-2.7b (the shared attention) and seamless-m4t-medium
  (the audio encoder); W x T ``gba_apply`` launches an apply, and the
  held bytes the rules' share between microsteps;
* granite-8b's FSDP step at 2 x 2 against the reference's single-device
  ``build_programs(mode="fused")`` with ``tests/test_torch_model_axis.py``'s
  tolerances;
* over gloo ranks, 4 as a 2 x 2 grid and 2 at 4 x 1
  (``selfcheck.run_model_axis(..., place_state=True)``): the FSDP step
  equals, bit for bit, the in-process FSDP step over the same data
  subgroup and ``place_state=False`` on the same ranks, and each rank
  holds the rules' share of the parameter bytes exactly; 4 data ranks
  are held on ``selfcheck``'s exact problem (its ``fsdp`` case, in
  ``tests/test_torch_dist.py``);
* ``launch.train --fused --mesh 2x2`` prints the bytes held.

The step tests run one torch thread, at 16 tokens a sequence.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import GBAConfig as JaxGBAConfig
from repro.launch.programs import build_programs as jax_build_programs
from repro_torch.configs import get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.gba import path_unflatten, tree_paths
from repro_torch.data import make_lm_stream
from repro_torch.distributed import fsdp, process_group, selfcheck
from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.programs import build_programs
from repro_torch.models import transformer as T
from test_torch_archs_fused import jax_apply_by_its_reference  # noqa: F401
from test_torch_archs_train import (  # noqa: F401 (fixtures)
    _outside_any_mesh, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
ARCHS = ("granite-8b", "gemma2-27b", "gemma3-12b", "starcoder2-3b",
         "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "mamba2-780m",
         "zamba2-2.7b", "llama-3.2-vision-11b", "seamless-m4t-medium")
STEP_ARCHS = ("granite-8b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
              "zamba2-2.7b", "seamless-m4t-medium")
DEVICE_PUT_ARCHS = ("granite-8b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                    "zamba2-2.7b")
MESHES = ((2, 2), (4, 1))
B, S_LEN, M, IOTA, LR, SEED = 2, 16, 4, 4, 1e-3, 6
TOKENS = [0, 0, 0, 0, 1, -5, 1, 1]
SPAWN_TIMEOUT = 240.0
# a re-layout window that cuts every layer group into several
WINDOW = 3000


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _batches(cfg, n=len(TOKENS), rows=B, seq=S_LEN):
    """The LM stream's batches (seed 0), a drawn memory for the cross
    archs, as numpy."""
    stream = make_lm_stream(cfg.vocab_size, seq, rows, seed=0)
    out = []
    for i in range(n):
        b = dict(stream.batch(i))
        if cfg.family in ("vlm", "audio"):
            key = "image_embeds" if cfg.family == "vlm" else "frames"
            length = cfg.num_image_tokens or cfg.encoder_frames
            b[key] = np.random.default_rng(50 + i).standard_normal(
                (rows, length, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_place_over_data_round_trips_bit_for_bit(arch, mesh):
    """Block (d, m) of every leaf is its contiguous rows and columns, a
    copy of its own, holding the rules' share of the bytes; the blocks
    put back together over ``data`` and then over ``model`` are the tree,
    bit for bit (bfloat16 weights)."""
    cfg = get_config(arch).reduced()
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    w, t = mesh
    mm = Mesh(("data", "model"), mesh)
    specs = S.param_specs(p, mm)
    blocks = fsdp.place(p, specs, mm, range(t), range(w))
    share = S.block_bytes(p, specs, mm)
    assert fsdp.held_bytes(blocks) == w * t * share
    whole = sum(x.numel() * x.element_size() for _, x in tree_paths(p))
    assert share < whole
    split = 0
    for (path, a), (_, spec) in zip(tree_paths(p), tree_paths(specs)):
        d = S.data_dims(spec)
        b00 = dict(tree_paths(blocks[0][0]))[path]
        assert b00.is_contiguous() and b00.data_ptr() != a.data_ptr()
        if d:
            split += 1
            assert b00.shape[d[0]] * w == a.shape[d[0]], path
    assert split > 0
    back = S.gather_model_shards(
        [S.gather_data_shards(per, specs, mm) for per in blocks], specs, mm)
    for (path, a), (_, b) in zip(tree_paths(p), tree_paths(back)):
        assert _same(a, b), path
    with pytest.raises(IndexError):
        S.place(p, specs, mm, 0, w)


# ---------------------------------------------------------------------------
# the step, in process
# ---------------------------------------------------------------------------

_MODELS = {}
# two repeats of the block pattern where ``.reduced()`` has one, so that
# the stacked leaves' gathers and sinks run per repeat; zamba2 as two
# repeats of (mamba, mamba_attn), its shared attention used in both
SHAPE = {"granite-8b": {"num_layers": 2}, "mamba2-780m": {"num_layers": 2},
         "zamba2-2.7b": {"num_layers": 4,
                         "block_pattern": ("mamba", "mamba_attn")}}


def _model(arch):
    if arch not in _MODELS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", **SHAPE.get(arch, {}))
        _MODELS[arch] = cfg, T.init_model(
            cfg, generator=torch.Generator().manual_seed(SEED),
            device="cpu")
    cfg, p = _MODELS[arch]
    return cfg, T._map(p, torch.clone)


def _run(cfg, p, mesh, place_state):
    """8 microsteps over ``mesh`` from ``p``: the programs, the state,
    the losses and the launches at each microstep; under FSDP the held
    bytes checked against the rules' share after each."""
    w, t = mesh
    progs = build_programs(cfg, GBAConfig(local_batch=B, buffer_size=M,
                                          staleness_tolerance=IOTA),
                           params=p, mode="fused", lr=LR, workers=w,
                           model=t, place_state=place_state)
    share = None
    if place_state:
        pl = progs.placement
        share = S.block_bytes(p, pl.specs, pl.mesh) * w * t
    st, losses, launches = progs.state, [], []
    for b, token in zip(_batches(cfg), TOKENS):
        calls = ops.kernel_calls["gba_apply_flat"]
        st, loss = progs.step(st, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, token)
        launches.append(ops.kernel_calls["gba_apply_flat"] - calls)
        losses.append(loss)
        if share is not None:
            assert fsdp.held_bytes(st["params"]) == share
    return progs, st, torch.stack(losses), launches


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_fsdp_step_equals_the_unplaced_step_bit_for_bit(
        arch, mesh, one_torch_thread):
    """2 global steps at M = 4, microstep 5's slot stale: losses, flat
    accumulator and every param bit for bit ``place_state=False``'s, W x
    T launches at microsteps 4 and 8 alone, the blocks holding the rules'
    share between microsteps (granite-8b, mamba2-780m and zamba2-2.7b at
    two repeats of their pattern, ``SHAPE``)."""
    cfg, p = _model(arch)
    got, gst, gl, gn = _run(cfg, T._map(p, torch.clone), mesh, True)
    want, wst, wl, wn = _run(cfg, p, mesh, False)
    w, t = mesh
    assert gn == wn == [0, 0, 0, w * t, 0, 0, 0, w * t]
    assert got.layout == want.layout and got.placement is not None
    assert _same(gl, wl)
    assert _same(gst["accum"], wst["accum"])
    assert gst["buffer"]["step"] == wst["buffer"]["step"] == 2
    trees = got.gather_params(gst["params"])
    wtrees = want.gather_params(wst["params"])
    if t == 1:
        trees, wtrees = [trees], [wtrees]
    for a, b in zip(trees, wtrees):
        for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
            assert _same(x, y), (arch, path)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fsdp_step_in_small_windows_equals_the_unplaced_step(
        mesh, monkeypatch, one_torch_thread):
    """granite-8b (two repeats) with the re-layouts cut into windows of
    ``WINDOW`` elements, so that slabs cross windows and data shards'
    parts: bit for bit ``place_state=False``; the bound on a re-layout's
    transient below one layer group's float32 extent."""
    monkeypatch.setattr(fsdp, "WINDOW", WINDOW)
    cfg, p = _model("granite-8b")
    got, gst, gl, _ = _run(cfg, T._map(p, torch.clone), mesh, True)
    want, wst, wl, _ = _run(cfg, p, mesh, False)
    assert _same(gl, wl) and _same(gst["accum"], wst["accum"])
    trees = got.gather_params(gst["params"])
    wtrees = want.gather_params(wst["params"])
    if mesh[1] == 1:
        trees, wtrees = [trees], [wtrees]
    for a, b in zip(trees, wtrees):
        for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
            assert _same(x, y), path
    assert fsdp.transient_bytes(got.placement) < \
        got.layout.peak_gather_bytes


def test_fsdp_step_matches_the_references_fused_step(
        monkeypatch, jax_apply_by_its_reference, one_torch_thread):
    """granite-8b over 2 x 2 with FSDP against the reference's
    single-device fused step (the reference's own sharded step fails on
    jax 0.9 here, ROADMAP.md queue 3), at ``test_torch_model_axis.py``'s
    tolerances: losses within rtol 1e-6, flat params and accumulator
    within rtol 1e-5 / atol 1e-7."""
    arch = "granite-8b"
    cfg, p = _model(arch)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32", num_layers=cfg.num_layers)
    assert cfg.num_repeats == 2
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p)
    gba = dict(local_batch=B, buffer_size=M, staleness_tolerance=IOTA)
    jprogs = jax_build_programs(jcfg, JaxGBAConfig(**gba), mode="fused",
                                params=jp, lr=LR)
    js, jl = jprogs.state, []
    for b, token in zip(_batches(cfg), TOKENS):
        js, loss = jprogs.step(js, {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(token, jnp.int32))
        jl.append(float(loss))
    progs, st, tl, _ = _run(cfg, p, (2, 2), True)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-6)
    tp, lay = progs.model_axis, progs.layout
    params = tp.gather_shards(progs.gather_params(st["params"]))
    accum = tp.gather_shards([
        lay.unravel(st["accum"][i * lay.padded_total:
                                (i + 1) * lay.padded_total], torch.float32)
        for i in range(2)])
    for tree, want in ((params, jprogs.layout.ravel(js["params"])),
                       (accum, js["accum"])):
        flat = np.concatenate([x.reshape(-1).numpy()
                               for _, x in tree_paths(tree)])
        np.testing.assert_allclose(flat, np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# over gloo ranks
# ---------------------------------------------------------------------------

def _granite():
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    return cfg, T.init_model(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")


@pytest.mark.parametrize("ranks,mesh,model_ranks", [
    (4, (2, 2), 2), (2, (4, 1), 1)], ids=["4ranks-2x2", "2ranks-4x1"])
def test_gloo_ranks_hold_fsdp_to_the_in_process_and_unplaced_steps(
        ranks, mesh, model_ranks):
    """granite-8b over gloo ranks, 2 global steps at M = 2, the re-layouts
    in windows of ``WINDOW`` elements: the FSDP step
    on the ranks equals, bit for bit, the FSDP step with every model shard
    in process over the same data subgroup and ``place_state=False`` on
    the same ranks (losses, each held model shard's params gathered over
    ``data`` and its accumulator), and every rank's blocks hold exactly
    the rules' share of the parameter bytes."""
    cfg, p = _granite()
    w, t = mesh
    gba = GBAConfig(local_batch=B, buffer_size=2, staleness_tolerance=IOTA)
    assert process_group.grid(ranks, w, t) == model_ranks
    with tempfile.TemporaryDirectory() as out:
        process_group.spawn(
            selfcheck.run_model_axis, ranks, gba,
            [(cfg, p, _batches(cfg, 4))], [0, 0, 1, 1], w, t, out, True,
            WINDOW, device="cpu", timeout=SPAWN_TIMEOUT,
            model_ranks=model_ranks)
        saved = [torch.load(f"{out}/rank{r}.pt") for r in range(ranks)]
    for r, (got,) in enumerate(saved):
        assert set(got) == {"ranks", "process", "unplaced"}
        assert np.isfinite(got["ranks"]["losses"].numpy()).all()
        for label in ("ranks", "process"):
            assert got[label].pop("bytes").tolist() == [0], (r, label)
        assert [k for k in got["ranks"] if k != "losses"] == [
            f"param/{m}" for m in range(r % model_ranks, t, model_ranks)
        ] + [f"accum/{m}" for m in range(r % model_ranks, t, model_ranks)]
        assert got["unplaced"].keys() == got["ranks"].keys()
        for label in ("process", "unplaced"):
            for k, v in got["ranks"].items():
                assert _same(v, got[label][k]), (r, label, k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_mesh_2x2_prints_the_bytes_held(capsys):
    """``launch.train --arch granite-8b --reduced --fused --mesh 2x2``:
    the bytes this process holds (all four blocks in process: the whole
    tree's bytes and the whole-over-data leaves' copies), the rules'
    share, the largest gather, and finite losses."""
    losses = train.main(["--arch", "granite-8b", "--reduced", "--fused",
                         "--mesh", "2x2", "--steps", "4", "--seq", "16",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and np.isfinite(losses).all()
    line = next(x for x in out.splitlines() if x.startswith("fsdp:"))
    assert "4 blocks" in line and "the rules' share" in line
    assert "largest gather" in line


# ---------------------------------------------------------------------------
# the reference's blocks (its subprocess runs beside the tests above)
# ---------------------------------------------------------------------------

_DEVICE_PUT = """
import sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.sharding import param_specs, to_named
from repro.models import transformer as JT

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
where = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(mesh.devices)}
out = {}
for arch in sys.argv[2:]:
    jp = JT.init_model(jax.random.PRNGKey(0), get_config(arch).reduced())
    placed = jax.device_put(jp, to_named(param_specs(jp, mesh), mesh))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    held, _ = jax.tree_util.tree_flatten_with_path(placed)
    for (path, x), (_, y) in zip(leaves, held):
        name = arch + "|" + "/".join(
            str(k.key) if hasattr(k, "key") else f"#{k.idx}" for k in path)
        out[name] = np.asarray(x).view(np.uint8)
        out[name + "|dtype"] = np.array(str(x.dtype))
        for shard in y.addressable_shards:
            d, m = where[shard.device.id]
            out[f"{name}|{d}{m}"] = np.asarray(shard.data).view(np.uint8)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def reference_blocks(tmp_path_factory):
    """The subprocess of :func:`test_blocks_are_the_references_device_put_
    blocks`, started with the file's first test so that it draws while the
    others run; killed at the end if it still runs."""
    tmp = tmp_path_factory.mktemp("device_put")
    with open(tmp / "stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DEVICE_PUT, str(tmp / "out.npz"),
             *DEVICE_PUT_ARCHS], env=ENV, cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=err)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def test_blocks_are_the_references_device_put_blocks(reference_blocks):
    """The reference's draw (bf16) of four archs placed over a 2 x 2 mesh
    by its ``device_put``: each device's block against the port's block
    (d, m) of the same draw carried across, bit for bit."""
    proc, tmp = reference_blocks
    code = proc.wait(timeout=300)
    assert code == 0, (tmp / "stderr").read_text()[-3000:]
    got = dict(np.load(tmp / "out.npz"))
    mm = Mesh(("data", "model"), (2, 2))
    for arch in DEVICE_PUT_ARCHS:
        names = [k.split("|")[1] for k in got
                 if k.startswith(arch + "|") and k.count("|") == 1]
        leaves = [got[f"{arch}|{n}"].view(np.dtype(
            str(got[f"{arch}|{n}|dtype"]))) for n in names]
        p = params_from_jax(path_unflatten(
            [tuple(n.split("/")) for n in names], leaves), device="cpu")
        specs = S.param_specs(p, mm)
        blocks = fsdp.place(p, specs, mm, range(2), range(2))
        seen = 0
        for d in range(2):
            for m in range(2):
                for path, leaf in tree_paths(blocks[m][d]):
                    want = got[f"{arch}|{'/'.join(path)}|{d}{m}"]
                    assert np.array_equal(
                        _bits(leaf).numpy().reshape(-1),
                        want.reshape(-1)), (arch, path, d, m)
                    seen += 1
        assert seen == 4 * len(names)
