"""The attention-family architectures of the port on the CPU against the
JAX package: gemma2-27b, gemma3-12b, starcoder2-3b, phi3.5-moe-42b-a6.6b
and kimi-k2-1t-a32b at ``.reduced()`` (forward, its aux loss and the
loss), and the layers they add (layernorm, the MoE, the sliding window's
ring cache, the attention softcap), and ``init_model``'s draw.

Model parameters are drawn by the port's ``init_model`` (a CPU draw in
one process, cheaper than compiling the reference's) and carried to the
reference as jax arrays; a single layer's are built by the JAX package and
carried across with ``params_from_jax``.  Inputs are numpy draws from a
seed.  The reference's model functions run under ``jax.jit`` (the
reference's own numbers at float32 rounding, and fast), outside any mesh,
with its module-global activation sharding cleared.

The MoE's routing is discontinuous: one ulp at the router's input can
change a ``top_k`` choice, and then the output.  So the expert choices
(``sel``), their ranks in their experts' queues (``slot``) and what is
kept (``keep``) are held exactly first, against the reference's own
routing lines applied to the reference's MoE inputs inside its compiled
forward, and only then the outputs within tolerance.  In bfloat16 the two packages round the MoE
inputs apart by an ulp or so (0.4 %), so a choice can flip at a margin
well above float32's: the parameter seed of the forward test (6) was
picked among 1 to 24 as one at which every choice of phi3.5-moe and
kimi-k2 holds in both dtypes (4 of the 24 do; in float32 alone, 21), and
each reference margin is also held above 1e-4.  A tolerance is never
widened to absorb a flip.

Tolerances, with their reasons:
* float32: logits within 1e-5 of their largest magnitude, the loss and
  the aux loss within rtol 1e-5 (float32 sums in other orders; at most
  1.7e-6 measured); layer outputs within 1e-5 of their largest; the
  ring cache exact (data movement);
* bfloat16: as ``tests/test_torch_lm.py`` holds granite-8b: logits within
  2**-6 of their largest magnitude, the loss within rtol 5e-4 (XLA and
  PyTorch round bfloat16 intermediates at different places), the aux loss
  within rtol 5e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.models.layers as JL
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
         "kimi-k2-1t-a32b")
B, S = 2, 80              # past the reduced window of 64
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-6, 5e-4)}  # logits, loss


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


def _cfgs(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                               **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              **over)
    return jcfg, cfg


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _params(cfg, seed=0):
    """The port's parameters and the same values as the reference's."""
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    return jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), dtype=_JDT[t.dtype]), p), p


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close_to_max(got, want, frac, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _jax_route_arrays(p, cfg, x):
    """The reference's routing lines (``repro/models/layers.py:315-343``)
    on an MoE layer's input x (B, S, D): sel, slot, keep and the router
    probabilities, as jax arrays."""
    B_, S_, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T_ = B_ * S_
    xt = x.reshape(T_, D)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, sel = lax.top_k(probs, K)
    cap = max(1, int(T_ * K / E * cfg.moe_capacity_factor))
    flat_sel = sel.reshape(-1)
    tk = flat_sel.shape[0]
    order = jnp.argsort(flat_sel, stable=True)
    counts_i = jnp.zeros((E,), jnp.int32).at[flat_sel].add(1)
    starts = jnp.cumsum(counts_i) - counts_i
    ranks_sorted = jnp.arange(tk, dtype=jnp.int32) - starts[flat_sel[order]]
    flat_slot = jnp.zeros((tk,), jnp.int32).at[order].set(ranks_sorted)
    return sel, flat_slot, flat_slot < cap, probs


def _route_record(K, sel, slot, keep, probs):
    """sel, slot, keep as numpy, and the least margin between a token's
    K-th and (K+1)-th router probability."""
    top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    margin = (top[:, K - 1] - top[:, K]).min() if K < top.shape[1] \
        else np.inf
    return {"sel": np.asarray(sel), "slot": np.asarray(slot),
            "keep": np.asarray(keep), "margin": float(margin)}


def jax_route(p, cfg, x):
    """The reference's routing of an MoE layer's input x (B, S, D)."""
    return _route_record(cfg.experts_per_token,
                         *_jax_route_arrays(p, cfg, x))


def _routes(monkeypatch):
    """Record the routes of both packages' MoE layers: the reference's
    through ``repro.models.layers.moe_fwd``, its routing lines traced
    beside the layer's own and their values passed out by an ordered
    ``jax.debug.callback`` (so a forward traced after this call records
    them under ``jax.jit``), the port's through ``layers.moe_route``."""
    seen = {"jax": [], "port": []}
    jax_moe, port_route = JL.moe_fwd, L.moe_route

    def jax_spy(p, cfg, x):
        jax.debug.callback(
            lambda *a: seen["jax"].append(
                _route_record(cfg.experts_per_token, *a)),
            *_jax_route_arrays(p, cfg, x), ordered=True)
        return jax_moe(p, cfg, x)

    def port_spy(p, cfg, xt):
        r = port_route(p, cfg, xt)
        seen["port"].append(r)
        return r

    monkeypatch.setattr(JL, "moe_fwd", jax_spy)
    monkeypatch.setattr(L, "moe_route", port_spy)
    return seen


def _same_routes(seen):
    assert len(seen["jax"]) == len(seen["port"]) > 0
    for i, (want, got) in enumerate(zip(seen["jax"], seen["port"])):
        assert want["margin"] > 1e-4, f"MoE layer {i}: a near-tie"
        np.testing.assert_array_equal(got["sel"].numpy(), want["sel"])
        np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
        np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])


# ---------------------------------------------------------------------------
# the five architectures: forward, aux and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_the_reference(arch, dtype, monkeypatch):
    jcfg, cfg = _cfgs(arch, dtype)
    jp, p = _params(cfg, seed=6)       # no near-tie at any MoE layer
    toks, labels = _tokens(cfg.vocab_size, 2), _tokens(cfg.vocab_size, 3)
    seen = _routes(monkeypatch)
    # a fresh function, so that this trace (with the route spy) is the
    # one compiled
    jlogits, jaux = jax.jit(lambda jp, t: JT.forward(jp, jcfg, t))(
        jp, jnp.asarray(toks))
    jax.effects_barrier()
    logits, aux = T.forward_aux(p, cfg, torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    tol_logits, tol_loss = TOL[dtype]
    _close_to_max(logits, jlogits, tol_logits, "logits")
    assert torch.equal(T.forward(p, cfg, torch.from_numpy(toks)), logits)
    jloss = jax.jit(JT.lm_loss, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    loss = T.lm_loss(p, cfg, torch.from_numpy(toks),
                     torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol_loss)
    if not cfg.num_experts:
        assert float(jaux) == aux.item() == 0.0
        assert seen == {"jax": [], "port": []}
        return
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=tol_loss)
    assert float(jaux) > 0.0
    # the aux term is in the loss: 0.01 * aux moves it by more than the
    # tolerance
    assert abs(cfg.router_aux_loss_weight * float(jaux)) > tol_loss * float(
        jloss)
    # the first forward of each package: one route an MoE layer
    n = sum(map(T._is_moe, (*cfg.prefix_layers,
                            *cfg.block_pattern * cfg.num_repeats)))
    _same_routes({k: v[:n] for k, v in seen.items()})


def test_granite_loss_has_no_aux_term():
    """A model without MoE layers: the loss is the mean NLL alone, bit for
    bit, as before the aux term existed."""
    _, cfg = _cfgs("granite-8b")
    p = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    toks, labels = (torch.from_numpy(_tokens(cfg.vocab_size, s))
                    for s in (4, 5))
    logp = torch.log_softmax(T.forward(p, cfg, toks), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    assert torch.equal(T.lm_loss(p, cfg, toks, labels), torch.mean(nll))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_matches_the_reference():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 256)) * 4 + 1.5).astype(np.float32)
    scale = (rng.standard_normal(256) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(256) * 0.1).astype(np.float32)
    want = JL.norm_fwd({"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = L.norm_fwd({"scale": torch.from_numpy(scale),
                      "bias": torch.from_numpy(bias)}, torch.from_numpy(x))
    _close_to_max(got, want, 1e-6, "layernorm")
    _, cfg = _cfgs("starcoder2-3b")
    spec = L.norm_spec(cfg)
    assert set(spec) == {"scale", "bias"}
    assert spec["bias"] == L.Leaf((256,), torch.float32, None)


def _moe_cfgs(E, K, factor=1.25):
    return _cfgs("kimi-k2-1t-a32b", num_experts=E, experts_per_token=K,
                 moe_capacity_factor=factor)


@pytest.mark.parametrize("case", [
    "phi3.5 reduced (E 4, K 2)",
    "forced capacity drop (factor 0.5)",
    "decode collision: cap 1 (E 32, K 8, 4 tokens)",
])
def test_moe_routes_and_output_match_the_reference(case):
    """sel, slot and keep exact, then the output and the aux loss; the
    collision case is kimi-k2's decode at B = 4 (capacity 1 a step) at 32
    experts, where several tokens choose one expert and all but the
    first are dropped.  Seeds picked with no near-tie."""
    E, K, factor, T_ = {
        "phi3.5 reduced (E 4, K 2)": (4, 2, 1.25, 24),
        "forced capacity drop (factor 0.5)": (4, 2, 0.5, 24),
        "decode collision: cap 1 (E 32, K 8, 4 tokens)": (32, 8, 1.25, 4),
    }[case]
    jcfg, cfg = _moe_cfgs(E, K, factor)
    jp = JL.init_moe(jax.random.PRNGKey(7), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(8).standard_normal(
        (1, T_, cfg.d_model)).astype(np.float32)
    want = jax_route(jp, jcfg, jnp.asarray(x))
    assert want["margin"] > 1e-4
    got = L.moe_route(p, cfg, torch.from_numpy(x[0]))
    np.testing.assert_array_equal(got["sel"].numpy(), want["sel"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    dropped = int((~got["keep"]).sum())
    if case.startswith("phi3.5"):
        assert dropped == 0
    else:
        assert dropped > 0 and got["cap"] == max(1, int(T_ * K / E * factor))
    y, aux = L.moe_fwd(p, cfg, torch.from_numpy(x))
    jy, jaux = JL.moe_fwd(jp, jcfg, jnp.asarray(x))
    _close_to_max(y, jy, 1e-5, "moe output")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    # a token whose every choice was dropped gets zeros
    none_kept = ~got["keep"].reshape(T_, K).any(-1)
    assert bool((y[0][none_kept] == 0).all())


def _kv(seed, s, kv=2, hd=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, s, kv, hd)).astype(np.float32),
            rng.standard_normal((2, s, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("s", [40, 64, 100, 128, 150])
def test_kv_to_cache_ring_matches_the_reference(s):
    """Window 64, cache 200: a prompt below, at and above the ring's
    length (100 and 150 leave a partial turn, 128 two whole ones); the
    ring is the reference's bit for bit and holds position p at p % 64."""
    jcfg, cfg = _cfgs("gemma3-12b")
    k, v = _kv(s, s)
    got = L.kv_to_cache(cfg, torch.from_numpy(k), torch.from_numpy(v), s,
                        200, window=64)
    want = JL.kv_to_cache(jcfg, jnp.asarray(k), jnp.asarray(v), s, 200,
                          window=64)
    for name, full in (("k", k), ("v", v)):
        assert got[name].shape == (2, 64, 2, 64)
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        for pos in range(max(0, s - 64), s):
            np.testing.assert_array_equal(got[name][:, pos % 64].numpy(),
                                          full[:, pos])
    short = L.kv_to_cache(cfg, torch.from_numpy(k), torch.from_numpy(v), s,
                          s + 8)                 # the global layer's cache
    assert short["k"].shape == (2, s + 8, 2, 64)


@pytest.mark.parametrize("pos", ["scalar", "vector"])
@pytest.mark.parametrize("kind", ["window", "softcap", "window+softcap"])
def test_attention_decode_with_window_and_softcap(kind, pos):
    """Three decode steps of one layer against the reference's, from a
    ring prefilled past its window (S 90, window 64) or a global cache:
    outputs within 1e-5 of their largest and the cache written alike (a
    (B,) position also at ragged slots)."""
    window = 64 if "window" in kind else 0
    softcap = 50.0 if "softcap" in kind else 0.0
    jcfg, cfg = _cfgs("gemma2-27b", attn_softcap=softcap)
    jp = JL.init_attention(jax.random.PRNGKey(9), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 90, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(90), (2, 90))
    _, (k, v) = JL.attention_fwd(jp, jcfg, jnp.asarray(x),
                                 jnp.asarray(positions), window=window,
                                 return_kv=True)
    jc = JL.kv_to_cache(jcfg, k, v, 90, 100, window)
    c = {n: torch.from_numpy(np.array(jc[n])) for n in ("k", "v")}
    at = np.array([90, 87], np.int32) if pos == "vector" else np.int32(90)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JL.attention_decode(jp, jcfg, jnp.asarray(xt), jc,
                                     jnp.asarray(at + step), window=window)
        y, c = L.attention_decode(p, cfg, torch.from_numpy(xt), c,
                                  torch.from_numpy(np.asarray(at + step)),
                                  window=window)
        _close_to_max(y, jy, 1e-5, f"step {step}")
        for n in ("k", "v"):
            _close_to_max(c[n], jc[n], 1e-6, f"cache {n}")


# ---------------------------------------------------------------------------
# init_model: one allocation a stacked leaf, the stacked draw's values
# ---------------------------------------------------------------------------

def _stacked_draw(cfg, gen):
    """What ``init_model`` drew before it allocated each stacked leaf once:
    every repeat's tree drawn in turn, each leaf ``(randn(shape) *
    scale).to(dtype)`` (zeros for norms), then ``torch.stack``."""
    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [draw(v) for v in spec]
        if spec.scale is None:
            return torch.zeros(spec.shape, dtype=spec.dtype)
        return (torch.randn(spec.shape, generator=gen)
                * spec.scale).to(spec.dtype)

    top_spec, block = T.model_spec(cfg)
    top = draw(top_spec)
    trees = [draw(block) for _ in range(cfg.num_repeats)]
    return {**top, "blocks": T._stack(trees)}


@pytest.mark.parametrize("arch", ["granite-8b", "phi3.5-moe-42b-a6.6b",
                                  "kimi-k2-1t-a32b"])
def test_init_model_equals_the_stacked_draw(arch):
    _, cfg = _cfgs(arch, "bfloat16")
    cfg = dataclasses.replace(
        cfg, num_layers=len(cfg.prefix_layers) + 3 * len(cfg.block_pattern))
    got = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    want = _stacked_draw(cfg, torch.Generator().manual_seed(3))
    g, w = T._leaves(got), T._leaves(want)
    assert len(g) == len(w) and list(got) == list(want)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)
    assert got["blocks"]["l0"]["ln1"]["scale"].shape == (3, cfg.d_model)
