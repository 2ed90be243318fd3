"""GBA aggregation: the pytree buffer and the flat buffer of the fused
apply.

Counterpart of ``repro.core.gba``.

The pytree half (Alg. 2 l.20-23):

* :func:`aggregate_dense` decays each of the M buffered gradients by the
  token-control rule, sums them and divides by ``N_a = M``, leaf by leaf;
* :func:`aggregate_embedding` treats the sparse module per ID: a row is
  decayed against the global step its ID last saw and divided by the
  number of slots that touched the ID;
* :func:`init_buffer` and :func:`buffer_push_and_maybe_apply` keep the M
  slots as a tree that mirrors the gradients, one leading M axis a leaf.
  The kernel-backed version of :func:`aggregate_dense` is
  ``repro_torch.kernels.ops.gba_aggregate_tree`` (one ``gba_aggregate``
  launch a leaf).

The flat half: a dense parameter tree ravels into one float32 vector
(:class:`FlatLayout`), the M buffered gradients live in one ``(M, N)``
float32 array, and an apply is ONE launch of the ``gba_apply`` kernel
(Alg. 2 l.20/22 and Adagrad) over the whole vector.

The reference's arrays are immutable and each push returns a new buffer.
Here a push, pytree or flat, writes the gradient and its token into the
buffer's slot in place, since a copy of the buffer would cost ``M * N``
elements a microstep; the returned dict shares the caller's tensors and
carries the new ``fill`` and ``step``, which are host integers.  The flat
apply updates the flat params and the Adagrad accumulator in place, as
the TPU kernel aliases them.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.staleness import DECAY_FNS
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import tree_map

Params = dict[str, Any]


def tree_paths(tree: Params, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs in ``jax.tree.flatten`` order: dict keys
    sorted, list entries in index order, depth first.  A list entry's
    name in the path is ``#i``, as the reference's ``path_names`` gives
    it."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _child(node: Any, name: str) -> Any:
    return node[int(name[1:])] if isinstance(node, list) else node[name]


def path_leaves(paths: tuple[tuple[str, ...], ...],
                tree: Params) -> list[torch.Tensor]:
    """The leaves of ``tree`` at ``paths``, in that order."""
    out = []
    for path in paths:
        node = tree
        for k in path:
            node = _child(node, k)
        out.append(node)
    return out


def _lists(node: Any) -> Any:
    """A dict whose keys are ``#0 .. #n-1`` as the list of its values."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k == f"#{i}" for i, k in enumerate(node)):
        return list(node.values())
    return node


def path_unflatten(paths: tuple[tuple[str, ...], ...],
                   leaves: list[torch.Tensor]) -> Params:
    """The nested dicts and lists that hold ``leaves[j]`` at
    ``paths[j]`` (a ``#i`` name is entry i of a list)."""
    tree: Params = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(tree)


# ---------------------------------------------------------------------------
# the pytree half
# ---------------------------------------------------------------------------

def decay_weights(tokens: torch.Tensor, global_step: int, iota: int,
                  strategy: str = "threshold") -> torch.Tensor:
    """(M,) float32 aggregation weights from the token-control rule."""
    return DECAY_FNS[strategy](tokens, global_step, iota)


def aggregate_dense(grads_stacked: Params, tokens: torch.Tensor,
                    global_step: int, iota: int,
                    strategy: str = "threshold") -> Params:
    """Tree of (M, ...) leaves -> the decayed mean over M, leaf by leaf, in
    each leaf's dtype.

    Alg. 2 l.22: the weighted sum is divided by N_a = M, so dropped slots
    shrink the gradient instead of renormalising it.  In float32, the
    products ``g[j] * w[j]`` are added one slot after another from +0.0
    and the sum is divided by M, which is how XLA reduces the reference's
    ``jnp.sum(g * w, axis=0) / m`` on the CPU (``torch.sum`` adds in
    another order)."""
    w = decay_weights(tokens, global_step, iota, strategy)
    m = w.shape[0]

    def agg(g):
        s = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
        for j in range(m):
            s = s + g[j].float() * w[j]
        return (s / m).to(g.dtype)

    return tree_map(agg, grads_stacked)


def aggregate_embedding(ids_stacked: torch.Tensor, rows_stacked: torch.Tensor,
                        tokens: torch.Tensor, last_update: torch.Tensor,
                        global_step: int, iota: int, capacity: int,
                        valid: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ID sparse aggregation (Alg. 2 l.21/23).

    ids_stacked (M, n) int ids per slot, rows_stacked (M, n, D) gradient
    rows, tokens (M,) int32, last_update (capacity,) int32 global step each
    ID last saw, valid optional (M, n) bool (False excludes an entry) ->
    (dense (capacity, D) float32, counts (capacity,) float32).

    An entry is padding when its ID lies outside ``[0, capacity)`` (the
    kernels' sentinel convention) or ``valid`` is False: it adds to neither
    the aggregate nor the counts.  A real entry is kept when its slot is
    within iota (``global_step - token <= iota``) or when its ID was not
    updated after the slot's token was issued (``last_update[id] <=
    token``: the row's data is unchanged, Insight 2).  Kept rows are summed
    per ID in entry order and divided by ``max(counts, 1)``, the number of
    kept entries of the ID.

    The sums and counts are one ``embedding_bag_grad`` call over the
    ``M * n`` entries as bags of one id, the entries not kept sent to the
    sentinel id ``capacity``: on a card its kernel sums each id's rows in
    entry order, so the result is deterministic, and on the CPU its plain
    version does the same."""
    d = rows_stacked.shape[-1]
    in_range = (ids_stacked >= 0) & (ids_stacked < capacity)
    if valid is not None:
        in_range = in_range & valid
    safe_ids = torch.where(in_range, ids_stacked, 0).long()
    slot_ok = (global_step - tokens) <= iota                     # (M,)
    id_fresh = last_update[safe_ids] <= tokens[:, None]          # (M, n)
    keep = (slot_ok[:, None] | id_fresh) & in_range

    kept_ids = torch.where(keep, safe_ids, capacity).to(torch.int32)
    dense, counts = ops.pooled_lookup_grad(
        kept_ids.reshape(-1, 1), rows_stacked.reshape(-1, d).float(),
        capacity)
    return dense / torch.clamp(counts, min=1.0)[:, None], counts


def init_buffer(params: Params, buffer_size: int) -> dict:
    """The M-slot pytree gradient buffer on the params' device: ``grads``,
    a tree of zeros with a leading M axis on each leaf in the leaf's dtype,
    ``tokens`` (M,) int32 zeros, ``fill`` and ``step`` 0."""
    dev = next(tree_paths(params))[1].device
    return {
        "grads": tree_map(lambda p: torch.zeros((buffer_size, *p.shape),
                                                dtype=p.dtype,
                                                device=p.device), params),
        "tokens": torch.zeros((buffer_size,), dtype=torch.int32, device=dev),
        "fill": 0,
        "step": 0,
    }


def buffer_push_and_maybe_apply(
        buffer: dict, grads: Params, token: int, iota: int,
        apply_fn: Callable[[Params], Any], noop_fn: Callable[[], Any],
        strategy: str = "threshold") -> tuple[Any, dict]:
    """Write one gradient tree (cast to the buffer's dtypes) and its token
    into slot ``fill % M``, in place; when the push fills the buffer,
    return ``apply_fn(aggregate_dense(...))`` over the slots, weighed
    against the step before the push, else ``noop_fn()``.  Returns ``(out,
    new_buffer)``; ``new_buffer["step"]`` is advanced on the push that
    filled the buffer.  The reference chooses with ``lax.cond``; here a
    Python ``if`` runs one branch."""
    m = buffer["tokens"].shape[0]
    slot = buffer["fill"] % m
    tree_map(lambda b, g: b[slot].copy_(g), buffer["grads"], grads)
    buffer["tokens"][slot] = token
    fill = buffer["fill"] + 1
    is_full = fill % m == 0
    if is_full:
        out = apply_fn(aggregate_dense(buffer["grads"], buffer["tokens"],
                                       buffer["step"], iota, strategy))
    else:
        out = noop_fn()
    return out, {"grads": buffer["grads"], "tokens": buffer["tokens"],
                 "fill": fill, "step": buffer["step"] + int(is_full)}


# ---------------------------------------------------------------------------
# the flat half
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlatLayout:
    """Ravel/unravel a dense parameter tree (nested dicts and lists of
    tensors) to one flat float32 vector.  Leaf ``j`` (in
    ``jax.tree.flatten`` order, the reference's) lives at
    ``flat[offsets[j] : offsets[j] + sizes[j]]``."""

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
