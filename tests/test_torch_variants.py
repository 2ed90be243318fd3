"""The reference's training-memory variants on the CPU against the JAX
package: ``attn_q_chunk``, ``loss_seq_chunk`` and ``remat_blocks`` alone
and together on granite-8b, gemma2-27b (its window of 64 binding at 96
tokens, and its softcaps) and llama-3.2-vision-11b (cross layers over a
memory, whose cross-attention is never chunked) at ``.reduced()`` in
float32; the query-chunked prefill; ``mamba_split_proj`` on mamba2-780m
and zamba2-2.7b; and the port's copy of the ``VARIANTS`` registry.

Parameters are drawn as in ``tests/test_torch_archs_cross_train.py`` (the
port's ``init_model`` at seed 6, the norms' fills drawn at 0.1 N(0, 1))
and carried to the reference as jax arrays; the split Mamba projections
are drawn by the reference's ``init_model`` with the field set and
carried to the port by ``convert.params_from_jax``.  The reference runs
jitted, outside any mesh.

Tolerances, with their reasons:
* a variant against the reference with the same fields: the loss within
  rtol 1e-6 and each gradient leaf within 1e-5 of its largest magnitude
  (``tests/test_torch_lm.py``'s float32 ``TOL``);
* a variant against the port's own baseline: the loss within 1e-5 and
  the gradients within rtol 1e-4 / atol 1e-5, the reference's own
  ``tests/test_perf_variants.py`` (a checkpoint runs the same operators
  again; the chunks sum the same products in other groupings);
* the prefill: logits and every cache leaf within 1e-5 of their largest;
* the split projections: logits and caches within 1e-5 of their largest,
  the loss within rtol 1e-5, the gradients as
  ``tests/test_torch_archs_ssm.py`` holds each arch (1e-5 of the largest
  for mamba2-780m, 5e-5 for zamba2-2.7b, whose reduced stack of 6 layers
  carries float32 rounding about ten times further);
* the registry: configs and options equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.flat_sharded import path_names
from repro.launch import programs as jax_programs
from repro.launch.variants import VARIANTS as JAX_VARIANTS
from repro.launch.variants import _gba_m16 as jax_gba_m16
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import GBAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.gba import tree_paths
from repro_torch.launch import programs
from repro_torch.launch.variants import VARIANTS, _gba_m16
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_archs_cross_train import _model
from test_torch_archs_train import (  # noqa: F401 (fixtures)
    _close_to_max, _outside_any_mesh, one_torch_thread)

ARCHS = ("granite-8b", "gemma2-27b", "llama-3.2-vision-11b")
B, S, CHUNK = 2, 96, 32
FIELDS = {"q_chunk": dict(attn_q_chunk=CHUNK),
          "loss_chunk": dict(loss_seq_chunk=CHUNK),
          "remat": dict(remat_blocks=True),
          "all": dict(attn_q_chunk=CHUNK, loss_seq_chunk=CHUNK,
                      remat_blocks=True)}
SSM = {"mamba2-780m": 1e-5, "zamba2-2.7b": 5e-5}   # gradient tolerances
CPU = torch.device("cpu")


def _batch(cfg, seed=3):
    """Tokens and labels (B, S), and for the VLM a drawn memory, as numpy."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    if cfg.num_image_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _port_grads(cfg, p, b):
    loss, grads = programs._grads_of(
        programs.make_loss_fn(cfg), p,
        {k: torch.from_numpy(v) for k, v in b.items()})
    return loss.item(), [g for _, g in tree_paths(grads)]


_BASE = {}


def _baseline(arch):
    """The port's float32 loss and gradients without a variant, once an
    arch."""
    if arch not in _BASE:
        _, cfg, _, p = _model(arch)
        _BASE[arch] = _port_grads(cfg, p, _batch(cfg))
    return _BASE[arch]


class _count:
    """Counts the calls of ``module.name`` within the block."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def spy(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("variant", list(FIELDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_variant_loss_and_gradients(arch, variant, monkeypatch):
    """The loss and every gradient leaf with the variant's fields against
    the reference's with the same fields, and against the port's own
    baseline; each field engages (its checkpointed function runs)."""
    jcfg, cfg, jp, p = _model(arch)
    fields = FIELDS[variant]
    jcfg = dataclasses.replace(jcfg, **fields)
    cfg = dataclasses.replace(cfg, **fields)
    b = _batch(cfg)
    counts = {"attn_q_chunk": _count(monkeypatch, L, "_q_chunk"),
              "loss_seq_chunk": _count(monkeypatch, T, "_chunk_nll"),
              "remat_blocks": _count(monkeypatch, T, "_repeat")}
    loss, grads = _port_grads(cfg, p, b)
    assert counts["attn_q_chunk"].n > 0 if "attn_q_chunk" in fields \
        else counts["attn_q_chunk"].n == 0
    assert counts["loss_seq_chunk"].n == (
        2 * S // CHUNK if "loss_seq_chunk" in fields else 0)
    # a checkpointed repeat runs again in the backward
    assert counts["remat_blocks"].n == cfg.num_repeats * (
        2 if "remat_blocks" in fields else 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda jp, b: jax_programs._loss_from_batch(jp, jcfg, b)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [path for path, _ in tree_paths(p)]
    assert [path_names(k) for k, _ in flat] == paths
    for path, g, (_, want) in zip(paths, grads, flat):
        _close_to_max(g.numpy(), want, 1e-5, "/".join(path))
    base_loss, base_grads = _baseline(arch)
    assert abs(loss - base_loss) < 1e-5
    for path, g, want in zip(paths, grads, base_grads):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{path}: {m}")


def _cache_leaves(cache, jcache, frac, what):
    for path, want in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        node = cache
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        name = f"{what} {jax.tree_util.keystr(path)}"
        if want.ndim == 0 or want.dtype == jnp.int32:
            np.testing.assert_array_equal(node.numpy(), np.asarray(want))
        else:
            _close_to_max(node.numpy(), want, frac, name)
    assert set(cache) == set(jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_query_chunked_prefill_matches_the_references(arch, monkeypatch):
    """Prefill of 96 tokens in query chunks of 32 (over the memory, for
    llama): the last logits and every cache leaf against the reference's
    prefill with the same field, the full k and v returned as before."""
    jcfg, cfg, jp, p = _model(arch)
    jcfg = dataclasses.replace(jcfg, attn_q_chunk=CHUNK)
    cfg = dataclasses.replace(cfg, attn_q_chunk=CHUNK)
    b = _batch(cfg)
    mem = b.get("image_embeds")
    chunks = _count(monkeypatch, L, "_q_chunk")
    logits, cache = T.prefill(p, cfg, torch.from_numpy(b["tokens"]),
                              None if mem is None else torch.from_numpy(mem),
                              cache_len=S + 4)
    # every layer's self-attention, a cross layer's too; never its xattn
    assert chunks.n == len(cfg.block_pattern) * cfg.num_repeats * S // CHUNK
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(b["tokens"]),
        None if mem is None else jnp.asarray(mem), S + 4)
    _close_to_max(logits.numpy(), jl, 1e-5, "prefill logits")
    _cache_leaves(cache, jc, 1e-5, "prefill cache")


# ---------------------------------------------------------------------------
# the split Mamba projections
# ---------------------------------------------------------------------------

def _split_cfgs(arch, full=False):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if not full:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return (dataclasses.replace(jcfg, dtype="float32", mamba_split_proj=True),
            dataclasses.replace(cfg, dtype="float32", mamba_split_proj=True))


@pytest.mark.parametrize("arch", list(SSM))
def test_split_proj_leaf_set_is_the_references(arch):
    """``model_spec`` with ``mamba_split_proj`` at full width: the
    reference's paths and shapes (``jax.eval_shape(init_model)``), the
    split leaves in place of ``in_proj`` and ``conv_w``, and the same
    parameter count as the fused layout."""
    jcfg, cfg = _split_cfgs(arch, full=True)
    want = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jcfg))
    top, block = T.model_spec(cfg)
    got = {path: (cfg.num_repeats, *s.shape) if path[0] == "blocks"
           else s.shape for path, s in tree_paths({**top, "blocks": block})}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert list(got) == [path_names(k) for k, _ in flat]
    for k, w in flat:
        assert got[path_names(k)] == w.shape, k
    mixer = block["l0"]["mixer"]
    assert {"w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
            "conv_C"} <= set(mixer) and "in_proj" not in mixer
    assert mixer["conv_B"].scale == 0.5
    fused = T.model_spec(get_config(arch))
    assert sum(int(np.prod(s)) for s in got.values()) == sum(
        int(np.prod(s.shape)) * (cfg.num_repeats if path[0] == "blocks"
                                 else 1)
        for path, s in tree_paths({**fused[0], "blocks": fused[1]}))


@pytest.mark.parametrize("arch", list(SSM))
def test_split_proj_matches_the_reference(arch):
    """From the reference's ``init_model`` with the field set (float32,
    the fills drawn at 0.1 N(0, 1)), carried by ``params_from_jax``: the
    logits, the loss and every gradient leaf; prefill of 40 tokens and 4
    decode steps with every cache leaf (the decode concatenates the three
    convs over the cache's conv window)."""
    jcfg, cfg = _split_cfgs(arch)
    rng = np.random.default_rng(9)

    def fill(path, x):
        if path_names(path)[-1] in ("scale", "bias", "A_log", "dt_bias",
                                    "D_skip"):
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    jp = jax.tree_util.tree_map_with_path(
        fill, jax.tree.map(np.asarray,
                           JT.init_model(jax.random.PRNGKey(4), jcfg)))
    p = params_from_jax(jp, device=CPU)
    assert "w_dt" in p["blocks"]["l0"]["mixer"]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 40)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jlogits, _ = jax.jit(JT.forward, static_argnums=1)(jp, jcfg,
                                                       jnp.asarray(toks))
    _close_to_max(T.forward(p, cfg, torch.from_numpy(toks)).numpy(),
                  jlogits, 1e-5, "logits")
    b = {"tokens": toks, "labels": labels}
    loss, grads = _port_grads(cfg, p, b)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda jp, b: jax_programs._loss_from_batch(jp, jcfg, b)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for (path, _), g, want in zip(tree_paths(p), grads,
                                  jax.tree.leaves(jgrads)):
        _close_to_max(g.numpy(), want, SSM[arch], "/".join(path))
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(toks), None, 48)
    logits, cache = T.prefill(p, cfg, torch.from_numpy(toks), cache_len=48)
    _close_to_max(logits.numpy(), jl, 1e-5, "prefill logits")
    _cache_leaves(cache, jc, 1e-5, "prefill cache")
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        logits, cache = T.decode_step(p, cfg, torch.from_numpy(tok), cache)
        _close_to_max(logits.numpy(), jl, 1e-5, f"decode {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    _cache_leaves(cache, jc, 1e-5, "decode cache")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _opts(opts):
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in opts.items()}


@pytest.mark.parametrize("name", list(JAX_VARIANTS))
def test_variants_are_the_references(name):
    """The same names in the same order; each transform gives, for every
    architecture, a config equal to the reference's, field for field, and
    equal options."""
    assert list(VARIANTS) == list(JAX_VARIANTS)
    for arch in ARCH_IDS:
        cfg, opts = VARIANTS[name](get_config(arch), {"seq": 1})
        jcfg, jopts = JAX_VARIANTS[name](jax_get_config(arch), {"seq": 1})
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert _opts(opts) == _opts(jopts), arch
        T.check_supported(cfg)


def test_gba_m16_gives_the_ports_gba_config():
    cfg = get_config("granite-8b")
    (got, opts), (_, jopts) = _gba_m16(cfg, {}), jax_gba_m16(
        jax_get_config("granite-8b"), {})
    assert got is cfg and isinstance(opts["gba"], GBAConfig)
    assert _opts(opts) == _opts(jopts)
