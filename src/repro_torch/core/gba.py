"""The flat gradient buffer of GBA's fused apply path.

Counterpart of the flat-buffer half of ``repro.core.gba``.  A dense
parameter tree ravels into one float32 vector (:class:`FlatLayout`), the M
buffered gradients live in one ``(M, N)`` float32 array, and an apply is
ONE launch of the ``gba_apply`` kernel (Alg. 2 l.20/22 and Adagrad) over
the whole vector.

The reference's arrays are immutable and each push returns a new buffer.
Here a push writes the gradient and its token into the buffer's slot in
place, since a copy of the buffer would cost ``M * N * 4`` bytes a
microstep; the returned dict shares the caller's tensors and carries the
new ``fill`` and ``step``, which are host integers.  The apply updates the
flat params and the Adagrad accumulator in place, as the TPU kernel aliases
them.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import ops

Params = dict[str, Any]


def tree_paths(tree: Params, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs in ``jax.tree.flatten`` order: dict keys
    sorted, depth first."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def path_leaves(paths: tuple[tuple[str, ...], ...],
                tree: Params) -> list[torch.Tensor]:
    """The leaves of ``tree`` at ``paths``, in that order."""
    out = []
    for path in paths:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def path_unflatten(paths: tuple[tuple[str, ...], ...],
                   leaves: list[torch.Tensor]) -> Params:
    """The nested dict that holds ``leaves[j]`` at ``paths[j]``."""
    tree: Params = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


@dataclass(frozen=True)
class FlatLayout:
    """Ravel/unravel a dense parameter tree (nested dicts of tensors) to one
    flat float32 vector.  Leaf ``j`` (in ``jax.tree.flatten`` order, the
    reference's) lives at ``flat[offsets[j] : offsets[j] + sizes[j]]``."""

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    total: int

    @classmethod
    def from_params(cls, params: Params) -> "FlatLayout":
        paths, leaves = zip(*tree_paths(params))
        shapes = tuple(tuple(x.shape) for x in leaves)
        sizes = tuple(math.prod(s) for s in shapes)
        offsets = tuple(itertools.accumulate(sizes, initial=0))[:-1]
        return cls(paths, shapes, tuple(x.dtype for x in leaves), sizes,
                   offsets, sum(sizes))

    def leaves(self, tree: Params) -> list[torch.Tensor]:
        return path_leaves(self.paths, tree)

    def unflatten(self, leaves: list[torch.Tensor]) -> Params:
        return path_unflatten(self.paths, leaves)

    def ravel(self, tree: Params) -> torch.Tensor:
        """Every leaf cast to float32 and laid end to end: a new (N,)
        tensor on the leaves' device."""
        leaves = self.leaves(tree)
        flat = torch.empty((self.total,), dtype=torch.float32,
                           device=leaves[0].device)
        for leaf, o, n in zip(leaves, self.offsets, self.sizes):
            flat[o:o + n].copy_(leaf.reshape(-1))
        return flat

    def unravel(self, flat: torch.Tensor) -> Params:
        """The tree of ``flat``, each leaf cast back to its own dtype into
        storage of its own (no leaf keeps ``flat`` alive)."""
        return self.unflatten([
            flat[o:o + n].reshape(s).to(dt, copy=True)
            for o, n, s, dt in zip(self.offsets, self.sizes, self.shapes,
                                   self.dtypes)])


def init_flat_buffer(params: Params, buffer_size: int
                     ) -> tuple[FlatLayout, dict]:
    """The flat M-slot gradient buffer on the params' device: ``grads``
    (M, N) float32 and ``tokens`` (M,) int32 zeros, ``fill`` and ``step``
    0.  Returns (layout, buffer)."""
    layout = FlatLayout.from_params(params)
    dev = layout.leaves(params)[0].device
    return layout, {
        "grads": torch.zeros((buffer_size, layout.total),
                             dtype=torch.float32, device=dev),
        "tokens": torch.zeros((buffer_size,), dtype=torch.int32, device=dev),
        "fill": 0,
        "step": 0,
    }


def flat_buffer_push(buffer: dict, flat_grad: torch.Tensor, token: int
                     ) -> tuple[dict, bool]:
    """Write one raveled gradient and its token into slot ``fill % M``, in
    place.  Returns ``(new_buffer, is_full)``: ``new_buffer["step"]`` is
    already advanced when the push filled the buffer, and its ``grads`` and
    ``tokens`` hold the slots for the apply that must follow."""
    m = buffer["tokens"].shape[0]
    slot = buffer["fill"] % m
    buffer["grads"][slot].copy_(flat_grad)
    buffer["tokens"][slot] = token
    fill = buffer["fill"] + 1
    is_full = fill % m == 0
    return {"grads": buffer["grads"], "tokens": buffer["tokens"],
            "fill": fill, "step": buffer["step"] + int(is_full)}, is_full


def flat_buffer_push_and_maybe_apply(
        buffer: dict, flat_grad: torch.Tensor, token: int,
        param_flat: torch.Tensor, accum_flat: torch.Tensor, lr: float, *,
        iota: int):
    """Push one raveled gradient; when the buffer fills, one ``gba_apply``
    launch updates ``param_flat`` and ``accum_flat`` in place, weighing
    each slot against the step before the push.  Returns ``(param_flat,
    accum_flat, applied, new_buffer)``; on a push that does not fill the
    buffer, params and accumulator are untouched.

    The fused train step (``repro_torch.launch.programs``) keeps its params
    as a tree and ravels them only when it applies, so, like the
    reference's, it calls :func:`flat_buffer_push` directly."""
    new_buffer, is_full = flat_buffer_push(buffer, flat_grad, token)
    if is_full:
        ops.gba_apply_flat(param_flat, accum_flat, new_buffer["grads"],
                           new_buffer["tokens"], buffer["step"], lr,
                           iota=iota)
    return param_flat, accum_flat, is_full, new_buffer
