"""The port's Mamba2/SSD mixer on the CPU against the JAX package's
(``repro.models.layers``): ``_segsum``, ``ssd_chunked`` with and without
an initial state, ``mamba_fwd`` with its decode cache at S = 40 (not a
multiple of ``.reduced()``'s chunk of 16, so the scan pads), ``mamba_decode``
from a drawn cache, and the mixer's leaf spec against ``init_mamba``'s.

Inputs and parameters are numpy draws from a seed, the same values on
both sides.  ``A_log``, ``dt_bias``, ``D_skip`` and the ``out_norm`` scale,
which ``init_mamba`` fills with zeros and ones, are drawn too: at those
fills a head-indexing fault in them would not show.  The reference runs
under ``jax.jit``.

Tolerances, with their reasons: float32 within 1e-5 of the largest
magnitude (float32 sums in other orders, cumulative sums and
exponentials of them; at most 2.4e-6 measured), the ``-inf`` pattern of
``_segsum`` exact; bfloat16 within 2**-6 of the largest (XLA keeps
float32 intermediates inside its fusions where PyTorch rounds each
operator to bfloat16), as ``tests/test_torch_archs_serve.py`` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.models import layers as L

ARCHS = ("mamba2-780m", "zamba2-2.7b")
B, S = 2, 40
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _both(x, dtype=torch.float32):
    """A numpy array as the port's tensor in ``dtype`` and the reference's
    array of the same values."""
    t = torch.tensor(np.asarray(x, np.float32)).to(dtype)
    return t, jnp.asarray(np.array(t.float().numpy()), dtype=_JDT[dtype])


def _close_to_max(got, want, frac, what=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (
        f"{what}: max|err| {err} > {frac} * {np.abs(want).max()}")


def _mixer(cfg, seed=0):
    """The mixer's parameters from ``mamba_spec``, every leaf drawn: the
    drawn ones at their scale, A_log, dt_bias and the norm scale at 0.5,
    D_skip around 1."""
    rng = np.random.default_rng(seed)
    port, ref = {}, {}

    def put(name, spec, dst_p, dst_j):
        if isinstance(spec, dict):
            dst_p[name], dst_j[name] = {}, {}
            for k, v in spec.items():
                put(k, v, dst_p[name], dst_j[name])
            return
        x = rng.standard_normal(spec.shape)
        x = x * spec.scale if spec.scale is not None else 0.5 * x + spec.fill
        dst_p[name], dst_j[name] = _both(x, spec.dtype)

    for k, v in L.mamba_spec(cfg).items():
        put(k, v, port, ref)
    return port, ref


def test_mixer_spec_matches_init_mamba():
    """Every leaf of ``mamba_spec`` at full width has ``init_mamba``'s
    path, shape and dtype, and the fills are the reference's (zeros, and
    ones for D_skip)."""
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = jax.eval_shape(lambda: JL.init_mamba(jax.random.PRNGKey(0),
                                                    jcfg))
        spec = L.mamba_spec(cfg)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        got = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_flatten_with_path(
                   spec, is_leaf=lambda x: isinstance(x, L.Leaf))[0]}
        assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in flat)
        for k, w in flat:
            leaf = got[jax.tree_util.keystr(k)]
            assert leaf.shape == w.shape, k
            assert str(leaf.dtype).removeprefix("torch.") == str(w.dtype), k
        real = JL.init_mamba(jax.random.PRNGKey(0), jcfg.reduced())
        np.testing.assert_array_equal(np.asarray(real["D_skip"]), 1.0)
        assert spec["D_skip"].fill == 1.0 and spec["D_skip"].scale is None
        for name in ("A_log", "dt_bias"):
            np.testing.assert_array_equal(np.asarray(real[name]), 0.0)
            assert spec[name].fill == 0.0 and spec[name].scale is None
        assert spec["out_norm"]["scale"].shape == (L.ssm_dims(cfg)[0],)


def test_segsum_matches_the_reference():
    x = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(
        np.float32)
    got = L._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(JL._segsum)(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(
        np.isneginf(got), np.broadcast_to(~np.tril(np.ones((16, 16), bool)),
                                          got.shape))
    fin = np.isfinite(want)
    _close_to_max(got[fin], want[fin], 1e-6, "segsum")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_ssd_chunked_matches_the_reference(with_h0):
    """The scan over 3 chunks of 16 (S = 48, the padded length of S =
    40), y and the final state, from zeros and from a drawn state."""
    _, cfg = _cfgs("zamba2-2.7b")
    _, H, N = L.ssm_dims(cfg)
    P, Sp, chunk = cfg.ssm_head_dim, 48, cfg.ssm_chunk
    rng = np.random.default_rng(2)
    xh, jxh = _both(rng.standard_normal((B, Sp, H, P)))
    dt, jdt = _both(np.log1p(np.exp(rng.standard_normal((B, Sp, H)))))
    a_log, ja = _both(0.5 * rng.standard_normal(H))
    bm, jb = _both(rng.standard_normal((B, Sp, N)))
    cm, jc = _both(rng.standard_normal((B, Sp, N)))
    h0 = jh0 = None
    if with_h0:
        h0, jh0 = _both(rng.standard_normal((B, H, P, N)))
    y, final = L.ssd_chunked(xh, dt, a_log, bm, cm, chunk, h0)
    jy, jfinal = jax.jit(JL.ssd_chunked, static_argnums=5)(
        jxh, jdt, ja, jb, jc, chunk, jh0)
    assert y.dtype == final.dtype == torch.float32
    _close_to_max(y, jy, TOL["float32"], "y")
    _close_to_max(final, jfinal, TOL["float32"], "final state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_fwd_and_its_cache_match_the_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    p, jp = _mixer(cfg)
    x, jx = _both(np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)), _TDT[dtype])
    out, cache = L.mamba_fwd(p, cfg, x, return_cache=True)
    jout, jcache = jax.jit(JL.mamba_fwd, static_argnums=(1, 3))(
        jp, jcfg, jx, True)
    frac = TOL[dtype]
    assert out.dtype == x.dtype
    _close_to_max(out, jout, frac, "out")
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == x.dtype
    _close_to_max(cache["ssm"], jcache["ssm"], frac, "ssm")
    _close_to_max(cache["conv"], jcache["conv"], frac, "conv")
    # the cache without it is the same forward
    assert torch.equal(L.mamba_fwd(p, cfg, x), out)


def test_mamba_fwd_refuses_a_cache_of_a_short_prompt():
    """A prompt of 1 or 2 tokens leaves a conv window shorter than
    CONV_W - 1, which the reference's decode cannot take: the port
    refuses it when a cache is asked for, and runs it when not."""
    _, cfg = _cfgs("mamba2-780m")
    p, _ = _mixer(cfg)
    x = torch.randn((1, 2, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    assert L.mamba_fwd(p, cfg, x).shape == x.shape
    with pytest.raises(ValueError, match="conv window"):
        L.mamba_fwd(p, cfg, x, return_cache=True)
    assert L.mamba_fwd(p, cfg, x[:, :1].expand(1, 3, -1).contiguous(),
                       return_cache=True)[1]["conv"].shape[1] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_matches_the_reference_in_place(arch, dtype):
    """Three recurrent steps from a drawn cache: each output and the cache
    after it; the port writes the state and the window into the cache's
    own tensors."""
    jcfg, cfg = _cfgs(arch, dtype)
    p, jp = _mixer(cfg, seed=4)
    rng = np.random.default_rng(5)
    empty = L.init_mamba_cache(cfg, B, torch.device("cpu"))
    ssm, jssm = _both(rng.standard_normal(empty["ssm"].shape))
    conv, jconv = _both(rng.standard_normal(empty["conv"].shape),
                        _TDT[dtype])
    cache, jcache = {"ssm": ssm, "conv": conv}, {"ssm": jssm, "conv": jconv}
    jdecode = jax.jit(JL.mamba_decode, static_argnums=1)
    frac = TOL[dtype]
    for step in range(3):
        x, jx = _both(rng.standard_normal((B, 1, cfg.d_model)), _TDT[dtype])
        out, new = L.mamba_decode(p, cfg, x, cache)
        jout, jcache = jdecode(jp, jcfg, jx, jcache)
        assert new["ssm"] is ssm and new["conv"] is conv
        _close_to_max(out, jout, frac, f"out {step}")
        _close_to_max(ssm, jcache["ssm"], frac, f"ssm {step}")
        _close_to_max(conv, jcache["conv"], frac, f"conv {step}")
