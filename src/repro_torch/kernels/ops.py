"""Public wrappers over the kernels, with the wrapper census, and the
tree-level helpers that apply a kernel across a parameter tree (nested
dicts of tensors), one launch a leaf.

Counterpart of ``repro.kernels.ops`` for the kernels ported so far.
"""
from __future__ import annotations

import collections
from typing import Any

import torch

from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_grad)
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.flash_decode import \
    flash_decode_partial as _flash_decode_partial
from repro_torch.kernels.fused_adagrad import fused_adagrad
from repro_torch.kernels.gba_aggregate import gba_aggregate
from repro_torch.kernels.gba_apply import gba_apply
from repro_torch.kernels.quantize import (dequantize, quantize_minmax,
                                          quantize_sign)
from repro_torch.optim.optimizers import tree_map

# Python-level invocation census of the wrappers below, as in the JAX
# package: a hot-ID cache hit must leave ``kernel_calls["pooled_lookup"]``
# unchanged, because the batch never reached the lookup kernel.  It counts
# wrapper invocations on any device; ``embedding_bag.launches`` and
# ``embedding_bag_grad.launches`` count the CUDA launches alone.
kernel_calls: collections.Counter = collections.Counter()


def pooled_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum-pooled lookup (B, F) x (V, D) -> (B, D) through the
    ``embedding_bag`` kernel."""
    kernel_calls["pooled_lookup"] += 1
    return embedding_bag(ids, table)


def pooled_lookup_grad(ids: torch.Tensor, grad_out: torch.Tensor,
                       capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter of (B, D) gradient rows into a (capacity, D) table gradient
    with per-id contributor counts, through the ``embedding_bag_grad``
    kernel (on sorted ids for D > 0, on the raw ids for D = 0)."""
    kernel_calls["pooled_lookup_grad"] += 1
    return embedding_bag_grad(ids, grad_out, capacity)


def gba_aggregate_tree(grads_stacked: Any, tokens: torch.Tensor, step: int,
                       *, iota: int) -> Any:
    """Kernel-backed version of ``repro_torch.core.gba.aggregate_dense``
    (threshold decay): each (M, ...) leaf is flattened to (M, -1), reduced
    by one ``gba_aggregate`` launch and given back its shape, in its
    dtype."""
    def per_leaf(g):
        flat = g.reshape(g.shape[0], -1)
        return gba_aggregate(flat, tokens, step, iota=iota).reshape(
            g.shape[1:])

    return tree_map(per_leaf, grads_stacked)


def adagrad_apply_tree(params: Any, grads: Any, accums: Any, lr: float
                       ) -> tuple[Any, Any]:
    """Adagrad over a tree, one ``fused_adagrad`` launch a leaf (flattened
    to 1-D).  Returns new ``(params, accums)`` trees and leaves the
    caller's tensors as they were, as the reference's functional helper
    does: the kernel updates clones in place."""
    new_p = tree_map(lambda p: p.clone(memory_format=torch.contiguous_format),
                     params)
    new_a = tree_map(lambda a: a.clone(memory_format=torch.contiguous_format),
                     accums)
    tree_map(lambda p, g, a: fused_adagrad(p.view(-1),
                                           g.contiguous().view(-1),
                                           a.view(-1), lr),
             new_p, grads, new_a)
    return new_p, new_a


def gba_apply_flat(param_flat: torch.Tensor, accum_flat: torch.Tensor,
                   buffer: torch.Tensor, tokens: torch.Tensor, step: int,
                   lr: float, *, iota: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused decay-aggregate + Adagrad over the flat (M, N) buffer, through
    the ``gba_apply`` kernel: the single-launch PS apply of the whole dense
    module (see ``repro_torch.core.gba.FlatLayout``).  Updates
    ``param_flat`` and ``accum_flat`` in place and returns them."""
    kernel_calls["gba_apply_flat"] += 1
    return gba_apply(param_flat, accum_flat, buffer, tokens, step, lr,
                     iota=iota)


def quantize_wire(x: torch.Tensor, *, tile: int, mode: str
                  ) -> tuple[torch.Tensor, ...]:
    """Quantize one (R, C) float32 routing payload per ``tile`` slice with
    error feedback, through the ``quantize_minmax`` (``mode="minmax"``:
    returns ``(q, scale, zero)``) or ``quantize_sign`` (``"sign"``:
    ``(q, scale)``) kernel.  ``x`` may be a strided view; it then holds the
    residual, in place."""
    kernel_calls["quantize_wire"] += 1
    if mode == "minmax":
        return quantize_minmax(x, tile=tile)
    if mode == "sign":
        return quantize_sign(x, tile=tile)
    raise ValueError(f"unknown quantize mode {mode!r}")


def dequantize_wire(q: torch.Tensor, *sidebands: torch.Tensor, tile: int,
                    mode: str, out: torch.Tensor) -> torch.Tensor:
    """Rebuild the float32 payload of routed wire arrays ``(q, scale,
    zero)`` (minmax) or ``(q, scale)`` (sign) into the (R, C) view ``out``
    through the ``dequantize`` kernel, and return it."""
    kernel_calls["dequantize_wire"] += 1
    zero = sidebands[1] if mode == "minmax" else None
    return dequantize(q, sidebands[0], zero, tile=tile, mode=mode, out=out)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int | torch.Tensor) -> torch.Tensor:
    """One-token GQA attention of q (B, KV, G, hd) over the KV cache k, v
    (B, L, KV, hd) up to the scalar position ``pos``, through the
    ``flash_decode`` kernel: the attention of every layer of the LM's
    decode step when the batch shares one position."""
    kernel_calls["flash_decode"] += 1
    return _flash_decode(q, k, v, pos)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int | torch.Tensor, start: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of q (B, KV, G, hd) over one slice k, v (B, L, KV,
    hd) of a KV sequence that starts at global position ``start``, up to
    the global position ``pos``, through the ``flash_decode`` kernel's
    partial contract (counted under ``kernel_calls["flash_decode"]``):
    each data shard's attention in the decode whose KV sequence the rules
    split over ``data``."""
    kernel_calls["flash_decode"] += 1
    return _flash_decode_partial(q, k, v, pos, start)
