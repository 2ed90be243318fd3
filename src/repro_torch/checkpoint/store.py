"""npz pytree checkpoints in the JAX package's layout.

Counterpart of ``repro.checkpoint.store``, reading and writing the same
files: a json ``__spec__`` (uint8 bytes) describing the tree, plus one
array per leaf under a flat key: ``/a/b`` for dict keys, ``/#i`` for list
and tuple positions, ``/@none`` for ``None``.  Leaves carry their dtype
name in the spec (``float32``, ``int32``, ``bfloat16``, ...); bfloat16 is
staged as float32 in the file, losslessly, and cast back on load.  A file
written by ``repro.checkpoint.save_pytree`` loads here as torch tensors,
and a file written here loads there.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def to_numpy(x: Any) -> np.ndarray:
    """One leaf as a numpy array on the host; bfloat16 becomes float32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:     # numpy has no bfloat16: stage f32
            t = t.float()
        return t.numpy()
    arr = np.asarray(x)
    if arr.dtype.kind == "V":             # ml_dtypes bfloat16 and the like
        arr = arr.astype(np.float32)
    return arr


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    elif tree is None:
        out[prefix + "/@none"] = np.zeros(0)
    else:
        out[prefix] = to_numpy(tree)
    return out


def _spec_of(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {"t": "d", "k": {k: _spec_of(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"t": "t", "k": [_spec_of(v) for v in tree]}
    if isinstance(tree, list):
        return {"t": "l", "k": [_spec_of(v) for v in tree]}
    if tree is None:
        return {"t": "n"}
    return {"t": "a", "d": _dtype_name(tree)}


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (dicts, lists, tuples, None, tensors, arrays and
    scalars) to the npz file ``path``."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __spec__=np.frombuffer(
        json.dumps(_spec_of(tree)).encode(), dtype=np.uint8), **flat)


def _rebuild(spec: Any, flat: dict[str, np.ndarray], prefix: str = "") -> Any:
    t = spec["t"]
    if t == "d":
        return {k: _rebuild(v, flat, f"{prefix}/{k}")
                for k, v in spec["k"].items()}
    if t in ("t", "l"):
        seq = [_rebuild(v, flat, f"{prefix}/#{i}")
               for i, v in enumerate(spec["k"])]
        return tuple(seq) if t == "t" else seq
    if t == "n":
        return None
    leaf = flat[prefix]      # ascontiguousarray alone makes a 0-d leaf (1,)
    arr = torch.from_numpy(np.ascontiguousarray(leaf).reshape(leaf.shape))
    dt = spec.get("d")
    if dt and str(arr.dtype).removeprefix("torch.") != dt:
        arr = arr.to(getattr(torch, dt))
    return arr


def load_pytree(path: str) -> Any:
    """Read a tree written by :func:`save_pytree` (or by the JAX package's)
    back as CPU tensors; tuples come back as plain tuples."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != "__spec__"}
        spec = json.loads(bytes(data["__spec__"]).decode())
    return _rebuild(spec, flat)
