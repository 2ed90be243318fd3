"""Parameter handoff between the JAX package and the port.

``params_from_jax`` takes the JAX package's parameters as a tree of numpy
arrays (``jax.tree.map(np.asarray, params)``, or a loaded checkpoint) and
returns the same tree of torch tensors on a device; ``params_to_numpy``
goes back.  Dicts keep their keys, lists and tuples their order, and a
NamedTuple with the fields of :class:`EmbeddingTable` becomes the port's
``EmbeddingTable``.  Values are copied bit for bit; numpy has no bfloat16,
so bfloat16 tensors leave as float32 (losslessly).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.store import to_numpy
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
