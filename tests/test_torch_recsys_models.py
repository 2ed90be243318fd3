"""The port's YouTubeDNN and DIEN, and its numpy copy of the reference's
initial draw, against the JAX package on the CPU.

Every model input is made with numpy from a seed (the click stream) and
the parameters are the JAX package's, carried across with
``params_from_jax``.  Tolerances:

* logits at the repo's full widths, batch 32: rtol 1e-5 / atol 1e-7
  (float32 sums in other orders: the behaviour mean, the attention's
  einsum and the GRU's products); the BCE loss rtol 1e-5;
* the gradient tree: rtol 1e-5 / atol 1e-8 for both models (DIEN's
  16-step recurrence did not need a looser bound);
* the GRU scan alone: rtol 1e-5 / atol 1e-7;
* ``jax_random``'s keys are exact; ``jax_init_recsys`` against
  ``repro.models.recsys.init_recsys(PRNGKey(s), cfg)``: the same keys,
  shapes and dtypes, and every value within 4 ulps (numpy's ``log1p``
  against XLA's in the normal draw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.recsys import RECSYS_CONFIGS as JAX_CONFIGS
from repro.models import recsys as JR
from repro_torch import jax_random
from repro_torch.configs.recsys import RECSYS_CONFIGS
from repro_torch.convert import (jax_init_recsys, params_from_jax,
                                 params_to_numpy)
from repro_torch.data import make_clickstream
from repro_torch.models import recsys as R
from repro_torch.optim import tree_map

MODELS = {"youtubednn": "private-youtubednn", "dien": "alimama-dien"}
DRAW_ULPS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The small models here run thousands of tiny operators: one
    intra-op thread keeps them from contending with the suite's other
    workers (an oversubscribed thread pool slowed them 100-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(model, seed=2, batch_seed=6, bs=32):
    name = MODELS[model]
    jcfg, cfg = JAX_CONFIGS[name], RECSYS_CONFIGS[name]
    jparams = JR.init_recsys(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(_numpy(jparams), device="cpu")
    batch = make_clickstream(cfg, seed=batch_seed, batch_size=bs).batch(0, 3)
    return jcfg, cfg, jparams, params, batch


@pytest.mark.parametrize("model", sorted(MODELS))
def test_logit_bce_loss_and_gradient_match_jax(model):
    jcfg, cfg, jparams, params, batch = _setup(model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        R.recsys_logit(params, cfg, tb).numpy(),
        np.asarray(jax.jit(JR.recsys_logit, static_argnums=1)(jparams, jcfg,
                                                              jb)),
        rtol=1e-5, atol=1e-7)
    jloss, jgrad = jax.jit(jax.value_and_grad(JR.bce_loss),
                           static_argnums=1)(jparams, jcfg, jb)
    g, loss = grad_and_value(R.bce_loss)(params, cfg, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got, want = dict(_leaves(params_to_numpy(g))), dict(_leaves(_numpy(jgrad)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_gradients_batch_under_vmap(model):
    """The trainer takes per-slot gradients with ``vmap(grad_and_value)``
    over stacked parameter versions and batches: each slot's equals its
    own unbatched call."""
    _, cfg, _, params, _ = _setup(model)
    stream = make_clickstream(cfg, seed=1, batch_size=8)
    raw = [stream.batch(0, i) for i in range(3)]
    batches = {k: torch.from_numpy(np.stack([b[k] for b in raw]))
               for k in raw[0]}
    other = params_from_jax(
        _numpy(JR.init_recsys(jax.random.PRNGKey(5), JAX_CONFIGS[
            MODELS[model]])), device="cpu")
    versions = [params, other, params]
    stacked = tree_map(lambda *xs: torch.stack(xs), *versions)
    fn = grad_and_value(lambda p, b: R.bce_loss(p, cfg, b))
    grads, losses = vmap(fn)(stacked, batches)
    for i in range(3):
        g, loss = fn(versions[i], {k: v[i] for k, v in batches.items()})
        torch.testing.assert_close(losses[i], loss, rtol=1e-6, atol=0)
        for (k, a), (_, b) in zip(_leaves(grads), _leaves(g)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-8,
                                       msg=k)


def test_gru_scan_matches_the_reference_step():
    rng = np.random.default_rng(0)
    d_in, d_h = 19, 19
    p = {"wx": rng.standard_normal((d_in, 3 * d_h)).astype(np.float32) / 4,
         "wh": rng.standard_normal((d_h, 3 * d_h)).astype(np.float32) / 4,
         "b": rng.standard_normal((3 * d_h,)).astype(np.float32) / 4}
    xs = rng.standard_normal((5, 16, d_in)).astype(np.float32)
    want = np.asarray(JR._gru_scan({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(xs)))
    got = R._gru_scan({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(xs)).numpy()
    assert got.shape == (5, 16, d_h)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_recsys_draws_the_reference_tree(model):
    name = MODELS[model]
    params = R.init_recsys(RECSYS_CONFIGS[name],
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    want = dict(_leaves(_numpy(JR.init_recsys(jax.random.PRNGKey(0),
                                              JAX_CONFIGS[name]))))
    got = dict(_leaves(params_to_numpy(params)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert R.sparse_dense_split(params)[0] == {"embed"}
    if model == "dien":
        assert got["/gru/wx"].shape == (19, 57)
        assert not got["/gru/b"].any()
    assert got["/mlp/w0"].shape[0] == {"dien": 190,
                                       "youtubednn": 336}[model]


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_jax_random_keys_are_exact(seed):
    key = jax.random.PRNGKey(seed)
    assert [int(x) for x in jax_random.prng_key(seed)] == \
        np.asarray(key).tolist()
    for n in (2, 3, 5):
        want = np.asarray(jax.random.split(key, n)).tolist()
        got = [[int(a), int(b)] for a, b in
               jax_random.split(jax_random.prng_key(seed), n)]
        assert got == want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(RECSYS_CONFIGS))
def test_jax_init_recsys_is_the_reference_draw(name, seed):
    got = dict(_leaves(params_to_numpy(
        jax_init_recsys(RECSYS_CONFIGS[name], seed, device="cpu"))))
    want = dict(_leaves(_numpy(JR.init_recsys(jax.random.PRNGKey(seed),
                                              JAX_CONFIGS[name]))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        ulps = np.abs(got[k].view(np.int32).astype(np.int64)
                      - v.view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= DRAW_ULPS, (k, ulps.max())
        # the draw's values are normals, not zeros: a wrong key shows
        if k.split("/")[-1][0] in "wae":
            assert np.abs(v).max() > 0, k
