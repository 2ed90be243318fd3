"""The port's sharding rule tables against the JAX package's, spec for
spec, for all ten architectures at their full shapes.

The reference's side is ``jax.eval_shape`` of its ``init_model`` and
``init_cache`` (``repro.launch.steps.abstract_params`` and
``abstract_cache``) on a ``jax.sharding.AbstractMesh``; the port's is
``models.transformer.param_shapes`` and ``cache_shapes`` (meta tensors)
on a ``launch.mesh.Mesh``.  Nothing is allocated at full size.  A port
spec is a plain tuple, so each leaf's ``tuple(jax_spec)`` must equal it.
The flat-state spec functions must accept and refuse the same layouts,
with the same messages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import repro.distributed.sharding as JS
from repro.configs import get_config as jax_get_config
from repro.core.flat_sharded import ShardedFlatLayout as JaxShardedLayout
from repro.core.flat_sharded import path_names
from repro.core.gba import FlatLayout as JaxFlatLayout
from repro.launch.steps import abstract_cache, abstract_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.core.gba import FlatLayout, tree_paths
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 16), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
_SHAPES = {}


def _meshes(i):
    sizes, names = MESHES[i]
    return AbstractMesh(sizes, names), M.Mesh(names, sizes)


def _shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = (abstract_params(jax_get_config(arch)),
                         T.param_shapes(get_config(arch)))
    return _SHAPES[arch]


def _is_spec(x):
    return isinstance(x, P)


def _by_path(jtree, ttree):
    """``{path: tuple(jax_spec)}`` and ``{path: port_spec}``."""
    want = {path_names(k): tuple(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jtree, is_leaf=_is_spec)[0]}
    return want, dict(tree_paths(ttree))


def _memory_len(cfg):
    return {"vlm": cfg.num_image_tokens,
            "audio": cfg.encoder_frames}.get(cfg.family, 0)


def test_meshes_are_the_references_shapes():
    from repro.launch import mesh as JM
    prod, pod = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert (prod.axis_names, prod.sizes) == (("data", "model"), (16, 16))
    assert (pod.axis_names, pod.sizes) == (("pod", "data", "model"),
                                           (2, 16, 16))
    assert M.make_smoke_mesh().shape == dict(JM.make_smoke_mesh().shape)
    assert M.parse_mesh("2x4").shape == {"data": 2, "model": 4}
    assert M.parse_mesh("4").shape == {"data": 4, "model": 1}
    for bad in ("2x", "x2", "axb", "0x2"):
        with pytest.raises(ValueError):
            M.parse_mesh(bad)
    assert not hasattr(M, "PEAK_FLOPS_BF16")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_are_the_references(arch):
    jshapes, shapes = _shapes(arch)
    want = {path_names(k): (tuple(v.shape), str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in tree_paths(shapes)}
    assert got == want


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jshapes, shapes = _shapes(arch)
    want, got = _by_path(JS.param_specs(jshapes, jmesh),
                         S.param_specs(shapes, tmesh))
    assert got == want
    assert S.data_axes(tmesh) == JS.data_axes(jmesh)
    want, got = _by_path(JS.stacked_specs(JS.param_specs(jshapes, jmesh), 2),
                         S.stacked_specs(S.param_specs(shapes, tmesh), 2))
    assert got == want


@pytest.mark.parametrize("budget", [8e9, 2e11])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_param_specs_equal_the_references(arch, budget):
    """An explicit budget on the (2, 4) and (16, 16) meshes: the reference's
    own 8e9, under which the large archs keep FSDP, and one that every
    arch fits."""
    jshapes, shapes = _shapes(arch)
    for i in (3, 5):
        jmesh, tmesh = _meshes(i)
        want, got = _by_path(JS.serve_param_specs(jshapes, jmesh, budget),
                             S.serve_param_specs(shapes, tmesh, budget))
        assert got == want


def test_serve_param_specs_takes_no_default_budget_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card gives the default budget")
    with pytest.raises(ValueError, match="hbm_budget"):
        S.serve_param_specs(T.param_shapes(get_config("granite-8b")),
                            M.make_production_mesh())


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_references(arch, batch):
    """A batch of 4 (over the data axes where it divides) and of 1 (the
    sequence-parallel cache) on every mesh, with the cross archs'
    memory."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    mem = _memory_len(cfg)
    jcache = abstract_cache(jcfg, batch, 256, mem)
    cache = T.cache_shapes(cfg, batch, 256, mem)
    want = {path_names(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert {p: tuple(x.shape) for p, x in tree_paths(cache)} == want
    for i in range(len(MESHES)):
        jmesh, tmesh = _meshes(i)
        want, got = _by_path(JS.cache_specs(jcache, jcfg, jmesh, batch),
                             S.cache_specs(cache, cfg, tmesh, batch))
        assert got == want, MESH_IDS[i]


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_batch_partition_equals_the_references(mesh):
    jmesh, tmesh = _meshes(mesh)
    for batch in (1, 2, 3, 4, 32, 64, 512):
        for ndim in (1, 2, 3):
            assert S.batch_partition(tmesh, batch, ndim) == tuple(
                JS.batch_partition(jmesh, batch, ndim)), (batch, ndim)


# ---------------------------------------------------------------------------
# the flat-state specs: the same layouts accepted, the same refused
# ---------------------------------------------------------------------------

def _tree(rng):
    shapes = {"a": (3, 700), "b": {"c": (5000,), "d": (64, 64)},
              "e": (2, 2, 3)}
    return {k: ({kk: rng.standard_normal(s).astype(np.float32)
                 for kk, s in v.items()} if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


def _group(names):
    return names[0]


def _outcome(fn):
    try:
        out = fn()
    except ValueError as e:
        return ("raises", str(e))
    return ("ok", out)


def _specs_equal(got, want):
    if isinstance(want, dict):
        return set(got) == set(want) and all(
            _specs_equal(got[k], want[k]) for k in want)
    return got == tuple(want)


BROKEN = [
    ("as built", {}),
    ("shards", {"num_shards": 4}),
    ("padded total", {"padded_total": 1}),
    ("group extent", {"group_sizes": None}),
    ("group total", {"group_sizes": "sum"}),
    ("leaf group", {"leaf_group": "past"}),
]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("case", range(len(BROKEN)),
                         ids=[b[0] for b in BROKEN])
def test_flat_state_specs_accept_and_refuse_as_the_references(case,
                                                              grouped):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    group = _group if grouped else None
    jlay = JaxShardedLayout.from_params(
        jax.tree.map(jax.numpy.asarray, tree), 2, 256, group_by=group)
    lay = ShardedFlatLayout.from_params(
        {k: (T._map(v, torch.from_numpy) if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in tree.items()}, 2, 256,
        group_by=group)
    for name in ("sizes", "offsets", "group_sizes", "padded_total"):
        assert getattr(lay, name) == getattr(jlay, name)
    change = dict(BROKEN[case][1])
    if change.get("group_sizes") is None and "group_sizes" in change:
        change["group_sizes"] = tuple(g + 256 for g in lay.group_sizes)
    elif change.get("group_sizes") == "sum":
        change["group_sizes"] = (*lay.group_sizes, 2 * 256)
        change["group_keys"] = (*lay.group_keys, "extra")
    if change.get("leaf_group") == "past":
        change["leaf_group"] = (*lay.leaf_group[:-1], lay.num_groups)
    jlay, lay = (dataclasses.replace(x, **change) for x in (jlay, lay))
    for i in range(len(MESHES)):
        jmesh, tmesh = _meshes(i)
        for axis in ("data", "model", "pod"):
            want = _outcome(lambda: JS.flat_slice_specs(jlay, jmesh, axis))
            got = _outcome(lambda: S.flat_slice_specs(lay, tmesh, axis))
            assert got[0] == want[0], (MESH_IDS[i], axis, got, want)
            if want[0] == "raises":
                assert got[1] == want[1]
            else:
                assert _specs_equal(got[1], want[1])
            for scheme in ("none", "int8", "onebit"):
                want = _outcome(lambda: JS.wire_state_specs(
                    jlay, jmesh, scheme, axis))
                got = _outcome(lambda: S.wire_state_specs(
                    lay, tmesh, scheme, axis))
                assert got[0] == want[0] and (
                    got[1] == want[1] if want[0] == "raises"
                    else _specs_equal(got[1], want[1]))
            want = _outcome(lambda: JS.fused_state_specs(
                jlay, jmesh, {"w": P(None)}, axis))
            got = _outcome(lambda: S.fused_state_specs(
                lay, tmesh, {"w": (None,)}, axis))
            assert got[0] == want[0] and (
                got[1] == want[1] if want[0] == "raises"
                else _specs_equal(got[1], want[1]))


def test_fused_state_specs_of_the_single_layout_are_replicated():
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((4, 5)).astype(np.float32)}
    jlay = JaxFlatLayout.from_params(jax.tree.map(jax.numpy.asarray, tree))
    lay = FlatLayout.from_params({"w": torch.from_numpy(tree["w"])})
    jmesh, tmesh = _meshes(1)
    want = JS.fused_state_specs(jlay, jmesh, {"w": P("model", None)})
    got = S.fused_state_specs(lay, tmesh, {"w": ("model", None)})
    assert _specs_equal(got, want)
