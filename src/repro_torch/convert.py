"""Parameter handoff between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameters as a tree of numpy
arrays (``jax.tree.map(np.asarray, params)``, or a loaded checkpoint) and
returns the same tree of torch tensors on a device; ``params_to_numpy``
goes back.  Dicts keep their keys, lists and tuples their order, and a
NamedTuple with the fields of :class:`EmbeddingTable` becomes the port's
``EmbeddingTable``.  Values are copied bit for bit; numpy has no bfloat16,
so bfloat16 tensors leave as float32 (losslessly).

``jax_init_recsys`` draws, without JAX, the tree that
``repro.models.recsys.init_recsys(jax.random.PRNGKey(seed), cfg)`` draws,
so the port's benches start from the reference's own initial weights.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch import jax_random
from repro_torch.checkpoint.store import to_numpy
from repro_torch.configs.recsys import RecsysConfig
from repro_torch.embeddings.table import EmbeddingTable
from repro_torch.kernels.runtime import resolve_device


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.array(x)                       # a copy the tensor may own
    if arr.dtype.kind == "V" and arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _map(tree: Any, leaf) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kind = (EmbeddingTable if tree._fields == EmbeddingTable._fields
                else type(tree))
        return kind(*(_map(v, leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    if tree is None:
        return None
    return leaf(tree)


def tree_to_device(tree: Any, device: torch.device) -> Any:
    """Every leaf as a tensor on ``device`` (tensors already there are
    returned as they are)."""
    return _map(tree, lambda x: _tensor(x).to(device))


def params_from_jax(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """The JAX package's parameters (a tree of numpy arrays) as the port's
    tensors on ``device``, e.g. the serving dict ``{"table":
    EmbeddingTable | tuple, "mlp": {"w0": ..., "b0": ...}}``."""
    return tree_to_device(tree, resolve_device(device))


def params_to_numpy(tree: Any) -> Any:
    """The port's parameters as a tree of numpy arrays on the host."""
    return _map(tree, to_numpy)


def _jax_mlp(key, dims: tuple[int, ...]) -> dict:
    """``repro.models.recsys._mlp_init``: one key a layer, ``w{i}`` the
    float32 quotient of the normal draw by ``sqrt(fan_in)``."""
    ks = jax_random.split(key, len(dims) - 1)
    w = {f"w{i}": jax_random.normal(ks[i], (dims[i], dims[i + 1]))
         / np.float32(math.sqrt(dims[i])) for i in range(len(dims) - 1)}
    b = {f"b{i}": np.zeros((dims[i + 1],), np.float32)
         for i in range(len(dims) - 1)}
    return w | b


def _jax_tree(cfg: RecsysConfig, key) -> dict:
    """The reference's ``init_deepfm``, ``init_youtubednn`` and
    ``init_dien`` as numpy arrays, split for split."""
    v, d = cfg.hash_capacity, cfg.embed_dim
    scale, f32 = np.float32(0.01), np.float32

    def embed(k):
        return jax_random.normal(k, (v, d)) * scale

    if cfg.model == "deepfm":
        k1, k2, k3 = jax_random.split(key, 3)
        return {"embed": embed(k1),
                "linear": jax_random.normal(k2, (v,)) * scale,
                "bias": np.zeros((), np.float32),
                "mlp": _jax_mlp(k3, (cfg.num_fields * d, *cfg.mlp_dims, 1))}
    if cfg.model == "youtubednn":
        k1, k2 = jax_random.split(key)
        return {"embed": embed(k1),
                "mlp": _jax_mlp(k2, ((cfg.num_fields + 2) * d,
                                     *cfg.mlp_dims, 1))}
    if cfg.model == "dien":
        k1, k2, k3, k4 = jax_random.split(key, 4)
        g1, g2 = jax_random.split(k2)
        root = f32(math.sqrt(d))
        return {"embed": embed(k1),
                "gru": {"wx": jax_random.normal(g1, (d, 3 * d)) / root,
                        "wh": jax_random.normal(g2, (d, 3 * d)) / root,
                        "b": np.zeros((3 * d,), np.float32)},
                "att_w": jax_random.normal(k3, (d, d)) / root,
                "mlp": _jax_mlp(k4, ((cfg.num_fields + 2) * d,
                                     *cfg.mlp_dims, 1))}
    raise ValueError(f"unknown recsys model {cfg.model!r}")


def jax_init_recsys(cfg: RecsysConfig, seed: int = 0, *,
                    device: str | torch.device = "cuda") -> dict:
    """The parameters ``repro.models.recsys.init_recsys(
    jax.random.PRNGKey(seed), cfg)`` draws, for all three models, as the
    port's tensors on ``device``: the same keys, shapes and dtypes, and
    values within a few ulps (numpy's ``log1p`` against XLA's)."""
    dev = resolve_device(device)
    return tree_to_device(_jax_tree(cfg, jax_random.prng_key(seed)), dev)
