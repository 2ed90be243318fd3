"""The port's trainer leftovers against the JAX package, on the CPU: the LR
schedules, the optimizer extras, ``CheckpointManager`` and
``configs.all_configs``.

Inputs are made with numpy from a seed and go through both packages.

Tolerances:
* each schedule equals the reference's at steps 0 to 120 to rtol 1e-6
  (float32 ``cos`` and ``sqrt`` may round one ulp apart);
* ``clip_by_global_norm`` and every optimizer over 3 steps to rtol 1e-5 /
  atol 1e-7, as ``test_torch_trainer.test_optimizers_match_jax`` holds the
  base optimizers: both sides run eagerly, op by op;
* checkpoints restore bit for bit, in both directions, bf16 included;
* ``all_configs``: the same keys in the same order, every shared field
  equal.

The reference's SGD momentum path turns bf16 params into float32 under a
float32 0-d ``lr_override``; the port keeps each param's dtype, so that
case is held against the reference with its params cast back to bf16
after each step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import all_configs as jax_all_configs
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch.programs import init_train_state
from repro_torch.models.transformer import init_model
from repro_torch.optim import (clip_by_global_norm, get_optimizer, sgd,
                               tree_leaves)
from repro_torch.optim import schedules as S

SCHEDULES = {
    "constant": ((0.3,), {}),
    "warmup_cosine": ((1.0,), dict(warmup_steps=10, total_steps=110)),
    "warmup_cosine_final": ((3e-4, 7, 97), dict(final_frac=0.05)),
    "inverse_sqrt": ((2.0,), dict(warmup_steps=16)),
    "step_decay": ((1.0,), dict(boundaries=(10, 20), factors=(0.5, 0.1))),
}


def _both(name):
    args, kw = SCHEDULES[name]
    fn = name.removesuffix("_final")
    return getattr(S, fn)(*args, **kw), getattr(JS, fn)(*args, **kw)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    port, ref = _both(name)
    steps = range(121)
    got = np.array([port(t).item() for t in steps], np.float32)
    want = np.array([float(ref(t)) for t in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # a 0-d tensor step, int or float, gives the same float32 0-d tensor
    for step in (torch.tensor(15, dtype=torch.int32), torch.tensor(15.0)):
        out = port(step)
        assert out.dtype == torch.float32 and out.shape == ()
        assert out.item() == port(15).item()


# -- the reference's tests/test_schedules_ckptmgr.py on the port ----------

def test_warmup_cosine_shape():
    s = S.warmup_cosine(1.0, warmup_steps=10, total_steps=110)
    assert float(s(0)) == 0.0
    assert abs(float(s(10)) - 1.0) < 1e-6
    assert float(s(5)) == pytest.approx(0.5)
    assert 0.1 < float(s(60)) < 1.0
    assert float(s(110)) == pytest.approx(0.1, abs=1e-6)
    vals = [float(s(t)) for t in range(10, 111, 10)]
    assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("sched, step, want", [
    (S.inverse_sqrt(2.0, warmup_steps=16), 16, 2.0),
    (S.inverse_sqrt(2.0, warmup_steps=16), 64, 1.0),
    (S.step_decay(1.0, boundaries=(10, 20), factors=(0.5, 0.1)), 5, 1.0),
    (S.step_decay(1.0, boundaries=(10, 20), factors=(0.5, 0.1)), 15, 0.5),
    (S.step_decay(1.0, boundaries=(10, 20), factors=(0.5, 0.1)), 25, 0.1),
    (S.constant(0.3), 1234, 0.3)],
    ids=["inverse_sqrt-16", "inverse_sqrt-64", "step_decay-5",
         "step_decay-15", "step_decay-25", "constant"])
def test_schedule_values(sched, step, want):
    assert float(sched(step)) == pytest.approx(want, rel=1e-6)


def test_schedule_with_optimizer():
    opt = sgd(999.0)  # base lr overridden
    params = {"w": torch.tensor([1.0])}
    state = opt.init(params)
    sched = S.step_decay(0.1, (1,), (0.5,))
    p1, state = opt.update(params, {"w": torch.tensor([1.0])}, state,
                           lr_override=sched(0))
    np.testing.assert_allclose(p1["w"].numpy(), [0.9], rtol=1e-6)


# -- clip_by_global_norm and the optimizer extras ---------------------------

def _tree(seed, dtype=np.float32):
    """A params-like tree of numpy arrays, one leaf a list entry."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "emb": (32, 4)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    tree["layers"] = [rng.standard_normal((4, 4)).astype(np.float32)]
    if dtype != np.float32:
        tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype)), tree)
    return tree


def _close(port_tree, jax_tree, rtol=1e-5, atol=1e-7):
    got = list(tree_leaves(params_to_numpy(port_tree)))
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(max_norm, dtype):
    jgrads = jax.tree.map(jnp.asarray, _tree(3, getattr(jnp, dtype)))
    grads = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    got, norm = clip_by_global_norm(grads, max_norm)
    want, jnorm = JO.clip_by_global_norm(jgrads, max_norm)
    assert norm.dtype == torch.float32 and norm.shape == ()
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-5)
    for g in tree_leaves(got):
        assert g.dtype == getattr(torch, dtype)
    _close(got, want)


# (name, kwargs, lr, override: None / "float" / "tensor", leaf dtype)
OPT_CASES = {
    "sgd-momentum": ("sgd", dict(momentum=0.9), 0.05, None, "float32"),
    "sgd-momentum-tensor-bf16": ("sgd", dict(momentum=0.9), 0.05, "tensor",
                                 "bfloat16"),
    "sgd-float-f32": ("sgd", {}, 999.0, "float", "float32"),
    "sgd-float-bf16": ("sgd", {}, 999.0, "float", "bfloat16"),
    "sgd-tensor-f32": ("sgd", {}, 999.0, "tensor", "float32"),
    "sgd-tensor-bf16": ("sgd", {}, 999.0, "tensor", "bfloat16"),
    "adagrad-tensor": ("adagrad", dict(initial_accum=0.5), 999.0, "tensor",
                       "float32"),
    "adam-weight-decay": ("adam", dict(weight_decay=0.1), 1e-2, None,
                          "float32"),
    "adam-weight-decay-tensor": ("adam", dict(weight_decay=0.1), 999.0,
                                 "tensor", "float32"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_extras_match_jax(case):
    name, kw, lr, override, dtype = OPT_CASES[case]
    jdt = getattr(jnp, dtype)
    jparams = jax.tree.map(jnp.asarray, _tree(0, jdt))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jopt, opt = JO.get_optimizer(name, lr, **kw), get_optimizer(name, lr, **kw)
    jstate, state = jopt.init(jparams), opt.init(params)
    jsched = JS.warmup_cosine(0.05, warmup_steps=1, total_steps=4)
    sched = S.warmup_cosine(0.05, warmup_steps=1, total_steps=4)
    for step in range(1, 4):
        jgrad = jax.tree.map(jnp.asarray, _tree(10 + step, jdt))
        grad = params_from_jax(jax.tree.map(np.asarray, jgrad), device="cpu")
        if override == "float":
            jo = o = 0.01 * step
        elif override == "tensor":
            jo, o = jsched(step), sched(step)
        else:
            jo = o = None
        jparams, jstate = jopt.update(jparams, jgrad, jstate, lr_override=jo)
        params, state = opt.update(params, grad, state, lr_override=o)
        # the port keeps each param's dtype (see the module docstring)
        jparams = jax.tree.map(lambda x: x.astype(jdt), jparams)
        for p in tree_leaves(params):
            assert p.dtype == getattr(torch, dtype)
        _close(params, jparams)
        _close({k: v for k, v in state.items() if k != "count"},
               {k: v for k, v in jstate.items() if k != "count"})


def test_get_optimizer_passes_keywords():
    assert get_optimizer("sgd", 0.1, momentum=0.9).init(
        {"w": torch.zeros(2)})["mom"]["w"].tolist() == [0.0, 0.0]
    assert get_optimizer("adagrad", 0.1, initial_accum=0.5).init(
        {"w": torch.zeros(2)})["accum"]["w"].tolist() == [0.5, 0.5]
    with pytest.raises(TypeError):
        get_optimizer("adagrad", 0.1, momentum=0.9)


# -- CheckpointManager ------------------------------------------------------

def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "new"), keep=2)
    for step in (1, 5, 9):
        mgr.save(step, {"params": {"w": torch.full((3,), float(step))},
                        "step": torch.tensor(step, dtype=torch.int32)})
    assert mgr.steps() == [5, 9]
    step, state = mgr.restore_latest(device="cpu")
    assert step == 9
    np.testing.assert_array_equal(state["params"]["w"].numpy(),
                                  np.full(3, 9.0, np.float32))
    assert int(mgr.restore(5, device="cpu")["step"]) == 5
    # the reference's manager reads the same directory and keeps the same
    assert JaxManager(mgr.dir).steps() == [5, 9]


def test_checkpoint_manager_restores_onto_the_card_by_default(
        tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "a" / "b"))
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest(device="cpu")
    mgr.save(3, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore_latest()


def _state_tree(seed):
    """A train state of numpy arrays with f32, bf16 and int32 leaves and a
    tuple."""
    rng = np.random.default_rng(seed)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16))
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "h": bf16},
            "opt": {"count": np.int32(3),
                    "m": (rng.standard_normal(6).astype(np.float32),
                          np.arange(4, dtype=np.int32))},
            "last_update": rng.integers(0, 9, 11).astype(np.int32)}


def _bits_equal(port_tree, jax_tree):
    got, want = jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape        # a 0-d leaf stays 0-d
        if w.dtype.kind == "V":                   # bfloat16
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), w)


def test_reference_checkpoints_restore_in_the_port(tmp_path):
    jmgr = JaxManager(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        jmgr.save(step, jax.tree.map(jnp.asarray, _state_tree(step)))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.steps() == [4, 6]
    step, state = mgr.restore_latest(device="cpu")
    assert step == 6 and isinstance(state["opt"]["m"], tuple)
    _bits_equal(state, _state_tree(6))


def test_port_checkpoints_restore_in_the_reference(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (2, 4, 6):
        mgr.save(step, params_from_jax(_state_tree(step), device="cpu"))
    step, state = JaxManager(str(tmp_path)).restore_latest()
    assert step == 6
    got = params_from_jax(jax.tree.map(np.asarray, state), device="cpu")
    _bits_equal(got, _state_tree(6))


def test_checkpoint_manager_roundtrip_train_state(tmp_path):
    cfg = get_config("mamba2-780m").reduced()
    params = init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    state = init_train_state(params, get_optimizer("adagrad", 1e-3))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    _, restored = mgr.restore_latest(device="cpu")
    want = [torch.as_tensor(x) for x in tree_leaves(state)]
    got = list(tree_leaves(restored))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# -- configs.all_configs ----------------------------------------------------

def test_all_configs_match_jax():
    got, want = all_configs(), jax_all_configs()
    assert list(got) == list(want) == list(ARCH_IDS)
    for arch in ARCH_IDS:
        assert got[arch] is get_config(arch)
        shared = ({f.name for f in dataclasses.fields(got[arch])}
                  & {f.name for f in dataclasses.fields(want[arch])})
        assert shared, arch
        for name in sorted(shared):
            assert getattr(got[arch], name) == getattr(want[arch], name), \
                (arch, name)
