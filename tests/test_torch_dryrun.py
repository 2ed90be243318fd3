"""``launch.dryrun``: one device's placed step traced on meta tensors.

The records at small meshes against what they must be (no collective at
one device; the kinds of collective at (2, 2), whose argument bytes
``tests/test_torch_steps.py`` holds to the reference's compiled step;
the flops of a reduced prefill against its matmuls counted by hand), two
full-width granite-8b steps on the 16 x 16 production mesh,
the skipped long context, the long-context decode of the four archs
that take it (``--all``'s last 8 records: 70 ok, 10 skipped, 0 not
ported), the resume of ``--out``, and the two pieces of
the model code that the meta trace needs: ``flash_decode``'s meta branch
and the MoE count that replaced ``torch.bincount``.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L

SHAPES = {"train": InputShape("t", 64, 8, "train"),
          "prefill": InputShape("p", 64, 4, "prefill"),
          "decode": InputShape("d", 64, 8, "decode")}
# the (arch, kind) cases at (2, 2) whose argument bytes
# tests/test_torch_steps.py holds to the reference's compiled step
CASES_2X2 = [(a, k) for a in ("granite-8b", "mamba2-780m",
                              "llama-3.2-vision-11b")
             for k in ("train", "prefill", "decode")]


def _cfg(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_device_issues_no_collective(kind):
    rec = dryrun.dryrun_step(_cfg("granite-8b"), SHAPES[kind],
                             Mesh(("data", "model"), (1, 1)))
    assert rec["collective_bytes"] == dict.fromkeys(dryrun.COLLECTIVES, 0)
    assert rec["flops"] > 0 and rec["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("arch,kind", CASES_2X2)
def test_collective_kinds_at_2x2(arch, kind):
    """Over (2, 2) every step gathers (weights over ``data``, activations
    over ``model``), and only train reduce-scatters (its gradients over
    ``data``)."""
    rec = dryrun.dryrun_step(_cfg(arch), SHAPES[kind],
                             Mesh(("data", "model"), (2, 2)))
    coll = rec["collective_bytes"]
    assert coll["all-gather"] > 0
    assert (coll["reduce-scatter"] > 0) == (kind == "train")


def test_prefill_flops_are_its_matmuls():
    """granite-8b ``.reduced()`` prefill of 4 x 64 tokens at (1, 1): the
    q, k, v and output projections, the scores and the weighted values of
    its one layer, the MLP's three matmuls, and the head on the last
    position, 2 flops a multiply-add."""
    cfg = _cfg("granite-8b")
    B, S = 4, 64
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, 64
    F, V = cfg.d_ff, cfg.vocab_size
    assert cfg.num_layers == 1 and cfg.resolved_head_dim == hd
    want = 2 * (B * S * D * (H + 2 * KV) * hd      # wq, wk, wv
                + 2 * B * H * S * S * hd           # scores, weighted values
                + B * S * H * hd * D               # wo
                + 3 * B * S * D * F                # the MLP
                + B * D * V)                       # the head, last position
    rec = dryrun.dryrun_step(cfg, SHAPES["prefill"],
                             Mesh(("data", "model"), (1, 1)))
    assert rec["flops"] == want


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_granite_full_width_on_the_production_mesh(shape):
    """granite-8b at full width, device (0, 0) of the 16 x 16 mesh: ``ok``
    in seconds; its held weights are the rules' share of 8.2 G bf16
    parameters (about 2 / 256 of 16.4 GB, the vocab split over model)."""
    rec = dryrun.dryrun_one("granite-8b", shape, False, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["trace_s"] < 60
    assert rec["flops"] > 0 and sum(rec["collective_bytes"].values()) > 0
    assert rec["memory"]["argument_bytes"] > 16.4e9 / 256


def test_long_context_without_it_is_skipped():
    rec = dryrun.dryrun_one("granite-8b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped"
    assert "500k decode" in rec["reason"]


LONG_ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "zamba2-2.7b")


def test_all_traces_the_long_context_decodes(tmp_path, capsys):
    """``--all`` over a file that holds every other record: the 8
    ``long_500k`` records of the archs that take it trace ``ok`` at 16 x
    16 and 2 x 16 x 16, 70 ok, 10 skipped, 0 not ported; each device
    holds the rules' share of the cache (its 1/16 of each KV sequence,
    split over ``data``) and combines its partial softmaxes by an
    all-gather."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import transformer as T
    out = tmp_path / "records.json"
    recs = []
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            for m in ("16x16", "2x16x16"):
                if s == "long_500k" and a in LONG_ARCHS:
                    continue
                status = ("skipped" if s == "long_500k" and not
                          get_config(a).supports_long_context else "ok")
                recs.append({"arch": a, "shape": s, "mesh": m,
                             "variant": "baseline", "status": status})
    out.write_text(json.dumps(recs))
    got = dryrun.main(["--all", "--out", str(out)])
    assert len(got) == 80
    assert "70 ok, 10 skipped, 0 not ported, 0 FAILED" in \
        capsys.readouterr().out
    shape = INPUT_SHAPES["long_500k"]
    for rec in got:
        if rec["shape"] != "long_500k" or rec["arch"] not in LONG_ARCHS:
            continue
        assert rec["status"] == "ok", rec
        cfg = get_config(rec["arch"])
        mesh = make_production_mesh(multi_pod=rec["mesh"] == "2x16x16")
        cache = T.cache_shapes(cfg, 1, shape.seq_len)
        assert rec["memory"]["cache_bytes"] == S.block_bytes(
            cache, S.cache_specs(cache, cfg, mesh, 1), mesh)
        assert rec["collective_bytes"]["all-gather"] > 0


def test_out_resumes(tmp_path, capsys):
    """``--all --out``: a record already ``ok``, ``skipped`` or
    ``not_ported`` in the file is kept; the one missing is traced and
    written back."""
    out = tmp_path / "records.json"
    recs = [{"arch": a, "shape": s, "mesh": m, "variant": "baseline",
             "status": "ok"}
            for a in ARCH_IDS for s in INPUT_SHAPES
            for m in ("16x16", "2x16x16")]
    missing = ("granite-8b", "decode_32k", "16x16")
    recs = [r for r in recs if (r["arch"], r["shape"], r["mesh"])
            != missing]
    out.write_text(json.dumps(recs))
    got = dryrun.main(["--all", "--out", str(out)])
    assert len(got) == 80
    assert "80 ok, 0 skipped, 0 not ported, 0 FAILED" in capsys.readouterr().out
    saved = {(r["arch"], r["shape"], r["mesh"]): r
             for r in json.loads(out.read_text())}
    assert len(saved) == 80 and "flops" in saved[missing]


def test_flash_decode_meta_branch_has_the_plain_shape_and_dtype():
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 4, 2, 64).to(dt)
        k = torch.randn(2, 40, 4, 64).to(dt)
        v = torch.randn(2, 40, 4, 64).to(dt)
        want = flash_decode_ref(q, k, v, 7)
        got = ops.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                               torch.tensor(7, device="meta"))
        assert got.device.type == "meta"
        assert got.shape == want.shape and got.dtype == want.dtype


def test_moe_count_is_bincount():
    """``layers.expert_counts`` (a scatter-add, which has a meta kernel)
    gives ``torch.bincount``'s integers, experts never chosen included,
    and ``moe_route`` runs on meta tensors."""
    gen = torch.Generator().manual_seed(0)
    for experts, n in ((4, 64), (16, 7), (384, 1024)):
        sel = torch.randint(0, experts, (n,), generator=gen)
        got = L.expert_counts(sel, experts)
        assert got.dtype == torch.int64
        assert torch.equal(got, torch.bincount(sel, minlength=experts))
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                              dtype="float32")
    r = L.moe_route({"router": torch.empty(cfg.d_model, cfg.num_experts,
                                           device="meta")}, cfg,
                    torch.empty(64, cfg.d_model, device="meta"))
    assert r["slot"].device.type == "meta" and r["slot"].shape == (128,)
