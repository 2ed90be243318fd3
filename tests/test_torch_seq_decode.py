"""The decode whose KV sequence the rules split over ``data`` (a batch that
does not divide the data axes: ``long_500k`` at batch 1).

* ``flash_decode_partial``'s plain version (the CPU dispatch of the
  kernel's partial contract): the float32 partials of any cut of L,
  combined by their log-sum-exps and rounded once, are the whole plain
  call within float32 rounding (bf16: within its bf16 ulp); its lse is
  the log-sum-exp of the scaled scores; a row with no position at or
  below the local position gives ``out = 0``, ``lse = -inf``; the meta
  branch has the kernel's shapes;
* the masked softmax of the local and softcapped layers over slices,
  normalised by the gathered max and sum before the bf16 cast, against
  the whole ``_sdpa``;
* ``place_cache`` cuts k and v into the held data shards' contiguous
  sequence slices and ``gather_cache`` puts them back bit for bit;
* ``build_step``'s decode of one sequence of the four long-context archs
  at ``.reduced()`` in float32 over (D, T) in (2, 1), (4, 1), (2, 2) and
  (2, 4) (starcoder2-3b's 2 KV heads over 4: the head_dim fallback),
  against the unplaced ``decode_step`` on the whole cache: next tokens
  equal, logits and the gathered cache within ``OUT_RTOL`` /
  ``OUT_ATOL`` (``tests/test_torch_steps.py``'s), from a position whose
  steps cross a slice boundary and from one inside the first slice (the
  later slices empty);
* the data combine: an ordered sum in process, one all-gather of ``(o,
  lse)`` a layer in the dry run's world;
* a batch that divides the data axes places no list.

The reference's compiled decode at batch 1 over (2, 2) is held in
``tests/test_torch_steps.py`` (its subprocess), 4 gloo ranks there too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.gba import tree_paths
from repro_torch.distributed import inprocess
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_decode_partial_ref, flash_decode_ref
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_archs_train import one_torch_thread  # noqa: F401

ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "zamba2-2.7b")
MESHES = ((2, 1), (4, 1), (2, 2), (2, 4))
# tests/test_torch_steps.py's float32 tolerances of the placed decode
OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
CACHE_LEN = 64
# a prompt whose 3 decode steps cross the slice boundary at 32 (D = 2, 4),
# and one inside the first slice of 16 (D = 4) and 32 (D = 2)
PROMPTS = {"crossing": 31, "first slice": 8}
STEPS = 3


def _cfg(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _qkv(b, length, kv, g, hd, dtype, seed):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    return draw(b, kv, g, hd), draw(b, length, kv, hd), draw(b, length, kv,
                                                           hd)


def _combine(parts):
    lse = torch.stack([l for _, l in parts])
    top = lse.amax(dim=0)
    w = torch.exp(lse - top)
    num = torch.zeros_like(parts[0][0])
    for wi, (o, _) in zip(w, parts):
        num += wi[..., None] * o
    return num / w.sum(dim=0)[..., None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cuts", [(0, 160), (0, 64, 160), (0, 17, 90, 160),
                                  (0, 32, 64, 96, 128, 160)],
                         ids=["whole", "2", "3 ragged", "5"])
@pytest.mark.parametrize("pos", [0, 40, 100, 159, 400])
def test_plain_partials_combine_to_the_whole_call(pos, cuts, dtype):
    """The plain float32 partials of the slices of a cut of L, weighed by
    their lse and rounded once to the inputs' dtype: the whole plain call
    within float32 rounding (bf16: one bf16 ulp)."""
    q, k, v = _qkv(2, 160, 3, 4, 64, dtype, seed=pos + len(cuts))
    want = flash_decode_ref(q, k, v, pos).float()
    parts = [flash_decode_partial_ref(q, k[:, a:b].contiguous(),
                                      v[:, a:b].contiguous(),
                                      torch.tensor(pos), a)
             for a, b in zip(cuts, cuts[1:])]
    assert all(o.dtype == torch.float32 for o, _ in parts)
    got = _combine(parts).to(dtype).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=2.0**-7, atol=1e-6)


def test_plain_partial_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v = _qkv(2, 700, 2, 3, 80, torch.float32, seed=1)
    for pos, start in ((650, 0), (650, 512), (3, 0)):
        out, lse = flash_decode_partial_ref(q, k[:, start:].contiguous(),
                                            v[:, start:].contiguous(), pos,
                                            start)
        s = torch.einsum("bngh,blnh->bngl", q,
                         k[:, start:pos + 1]) / math.sqrt(80)
        torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                                   rtol=1e-6, atol=1e-5)
        assert torch.equal(out, flash_decode_ref(
            q, k[:, start:].contiguous(), v[:, start:].contiguous(),
            pos - start))


@pytest.mark.parametrize("pos", [-1, 99, torch.tensor(99)])
def test_plain_partial_empty_row_is_zero_with_lse_minus_inf(pos):
    """No position at or below ``pos - start`` (a slice wholly past the
    position, or ``pos < 0``): ``out = 0``, ``lse = -inf``, where the old
    contract gives the mean of v."""
    q, k, v = _qkv(1, 64, 2, 2, 64, torch.float32, seed=2)
    start = 0 if isinstance(pos, int) and pos < 0 else 100
    out, lse = ops.flash_decode_partial(q.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), pos, start)
    assert out.dtype == lse.dtype == torch.float32
    assert not out.any() and lse.shape == (1, 2, 2)
    assert bool((lse == -math.inf).all())
    assert bool(flash_decode_ref(q, k, v, -1).any())


def test_partial_meta_branch_has_the_kernels_shapes():
    q, k, v = (x.to("meta") for x in _qkv(2, 40, 4, 2, 64,
                                         torch.bfloat16, seed=3))
    out, lse = ops.flash_decode_partial(q, k, v,
                                        torch.tensor(7, device="meta"), 20)
    assert out.device.type == lse.device.type == "meta"
    assert out.shape == q.shape and out.dtype == torch.float32
    assert lse.shape == (2, 4, 2) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("where", ["global", "ring"])
def test_split_softmax_is_the_whole_sdpa(where, softcap, dtype):
    """The masked softmax over 4 slices (the local ring's ``abs_pos`` rule
    or a global mask, softcapped or not), its max and sum gathered before
    each probability's cast: the whole ``_sdpa`` within float32 rounding,
    the bf16 probabilities the whole's; the last slices, which hold no
    valid slot under the global mask, add nothing."""
    q, k, v = _qkv(1, 64, 2, 2, 64, dtype, seed=4)
    q5 = q.reshape(1, 1, 2, 2, 64)
    idx = torch.arange(64)[None, :]
    pos = torch.tensor([[20]])
    valid = ((pos - torch.remainder(pos - idx, 64) >= 0) if where == "ring"
             else idx <= pos)
    want = L._sdpa(q5, k, v, valid[:, None, :], softcap)
    tp = TP.model_axis(_cfg("gemma3-12b"), Mesh(("data", "model"), (4, 1)),
                       inprocess)
    scores = [L._scores(q5, k[:, a:a + 16], valid[:, None, a:a + 16],
                        softcap) for a in range(0, 64, 16)]
    got = L._split_softmax(scores, [v[:, a:a + 16] for a in range(0, 64, 16)],
                           tp)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
def test_place_and_gather_cache_round_trip(mesh):
    """Each k and v leaf the rules split over the sequence: the held data
    shards' slices, each a contiguous tensor of its own, equal to the
    whole cache's block; the Mamba2 and ``pos`` leaves cut as before; the
    gathered cache the whole one, bit for bit."""
    cfg = _cfg("zamba2-2.7b")
    m = Mesh(("data", "model"), mesh)
    whole = T.init_cache(cfg, 1, CACHE_LEN, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for _, x in tree_paths(whole):
        if x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=gen))
    step, args = steps.build_step(cfg, InputShape("d1", CACHE_LEN, 1,
                                                  "decode"), m)
    caches = step.place_cache(whole)
    n = CACHE_LEN // mesh[0]
    attn = caches[0]["blocks"]["l5"]["attn"]
    assert isinstance(attn["k"], list) and len(attn["k"]) == mesh[0]
    for d, sl in enumerate(attn["k"]):
        assert sl.is_contiguous() and sl.shape[2] == n
        kv = sl.shape[3]
        assert torch.equal(sl, whole["blocks"]["l5"]["attn"]["k"][
            :, :, d * n:(d + 1) * n, :kv])
    assert isinstance(caches[0]["blocks"]["l0"]["ssm"]["ssm"],
                      torch.Tensor)
    meta = args[2][0]["blocks"]["l5"]["attn"]["k"]
    assert [x.shape for x in meta] == [x.shape for x in attn["k"]]
    back = step.gather_cache(caches)
    for (p, a), (_, b) in zip(tree_paths(back), tree_paths(whole)):
        assert torch.equal(a, b), p


def test_a_batch_that_divides_data_places_no_slices():
    cfg = _cfg("gemma3-12b")
    _, args = steps.build_step(cfg, InputShape("d", CACHE_LEN, 2, "decode"),
                               Mesh(("data", "model"), (2, 2)))
    paths = [p for p, _ in tree_paths(args[2][0])]
    assert paths and not any(p[-1].startswith("#") for p in paths)


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_split_decode_is_the_unplaced_decode(arch, mesh, prompt,
                                             one_torch_thread):
    """``STEPS`` greedy steps of ``build_step``'s batch-1 decode against
    ``decode_step`` on the whole cache: the same next tokens, logits and
    gathered cache within the stated tolerances; each k and v leaf the
    rules split held as the data shards' slices."""
    cfg = _cfg(arch)
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, PROMPTS[prompt]),
                         generator=torch.Generator().manual_seed(4))
    _, cache = T.prefill(params, cfg, toks, cache_len=CACHE_LEN)
    m = Mesh(("data", "model"), mesh)
    dec, _ = steps.build_step(cfg, InputShape("d1", CACHE_LEN, 1, "decode"),
                              m)
    caches = dec.place_cache(T._map(cache, torch.clone))
    assert any(isinstance(x, list) for c in caches
               for x in _lists(c)), "no leaf split over data"
    held = dec.place_params(params)
    tok = want_tok = toks[:, -1:].to(torch.int32)
    want_c = cache
    for _ in range(STEPS):
        tok, logits, caches = dec(held, tok, caches)
        want_l, want_c = T.decode_step(params, cfg, want_tok, want_c)
        want_tok = torch.argmax(want_l, dim=-1).to(torch.int32)
        assert torch.equal(tok, want_tok)
        torch.testing.assert_close(logits, want_l, rtol=OUT_RTOL,
                                   atol=OUT_ATOL)
    for (p, a), (_, b) in zip(tree_paths(dec.gather_cache(caches)),
                              tree_paths(want_c)):
        torch.testing.assert_close(a, b, rtol=OUT_RTOL, atol=OUT_ATOL,
                                   msg=str(p))


def _lists(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _lists(v)]
    return [tree]


def test_seq_combine_in_process_and_in_the_dry_runs_world():
    """In process the combine is the ordered sum of the held partials; the
    dry run's world answers it with one all-gather of the packed
    ``(o, lse)``, D times one shard's bytes."""
    cfg = _cfg("gemma3-12b")
    mesh = Mesh(("data", "model"), (4, 1))
    tp = TP.model_axis(cfg, mesh, inprocess)
    q, k, v = _qkv(1, 64, 2, 2, 64, torch.float32, seed=6)
    parts = [flash_decode_partial_ref(q, k[:, a:a + 16].contiguous(),
                                      v[:, a:a + 16].contiguous(), 37, a)
             for a in range(0, 64, 16)]
    got = tp.seq_combine(parts)
    assert torch.equal(got, _combine(parts))
    world = dryrun.MetaWorld(mesh)
    meta = TP.model_axis(cfg, mesh, world)
    out = meta.seq_combine([tuple(x.to("meta") for x in parts[0])])
    assert out.shape == q.shape and out.device.type == "meta"
    assert world.bytes["all-gather"] == 4 * q.numel() * 4 // 64 * 65


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_decode_builds_on_the_production_mesh(arch):
    """``build_step(cfg, INPUT_SHAPES["long_500k"], mesh)``: device (0, 0)
    of the 16 x 16 mesh holds its 32,768-position slice of each global
    cache (its ring's slice where a ring of the window divides 16)."""
    mesh = Mesh(("data", "model"), (16, 16))
    cfg = get_config(arch)
    step, args = steps.build_step(cfg, INPUT_SHAPES["long_500k"], mesh,
                                  world=dryrun.MetaWorld(mesh))
    lengths = {x.shape[2] for p, x in tree_paths(args[2])
               if p[-2] in ("k", "v")}
    assert lengths and lengths <= {524_288 // 16,
                                   (cfg.sliding_window or 0) // 16}
    assert step.tp.seq_shards() == range(1)
