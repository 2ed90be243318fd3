"""Plain PyTorch versions of the kernels.

The CPU tests hold them against the JAX package, the wrappers use them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

import torch

# Adagrad's epsilon, added after the square root (the reference's default;
# no ported caller sets another)
EPS = 1e-10


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) int ids, (V, D) table -> (B, D) sum-pool in the table's dtype,
    accumulated in float32.

    Follows the kernel's contract, not JAX indexing: every id outside
    ``[0, V)`` (negative ids, the padding sentinel ``V``) contributes a zero
    row.  ``repro.kernels.ref.embedding_bag_ref`` instead wraps negative ids
    and clamps large ones, so the two agree on in-range ids only."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0).long()].float()    # (B, F, D)
    rows = torch.where(valid[..., None], rows, 0.0)
    return rows.sum(dim=1, dtype=torch.float32).to(table.dtype)


def embedding_bag_grad_ref(ids: torch.Tensor, grad_out: torch.Tensor,
                           capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, F) int ids, (B, D) grad_out -> (gtable (capacity, D), counts
    (capacity,)), both float32: entry ``(b, f)`` adds ``grad_out[b]`` to
    row ``ids[b, f]`` and 1 to its count.

    Follows the kernel's contract: ids outside ``[0, capacity)`` add
    nothing (``index_add_`` would raise on them, and
    ``repro.kernels.ref.embedding_bag_grad_ref`` wraps negative ids, so the
    two agree on in-range ids only).  They are sent to row 0 with a zero
    row and a zero count instead of being dropped by a boolean mask, which
    would make the host wait for the device; adding +0.0 leaves every sum
    as it was.  On a CPU tensor ``index_add_`` adds the entries one after
    another in entry order, from 0.0, which is the kernel's order: the two
    agree bit for bit.  On a CUDA tensor it adds with atomics, in no fixed
    order."""
    f = ids.shape[1]
    gtable = torch.zeros((capacity, grad_out.shape[1]), dtype=torch.float32,
                         device=grad_out.device)
    counts = torch.zeros((capacity,), dtype=torch.float32,
                         device=grad_out.device)
    if capacity == 0:
        return gtable, counts
    flat = ids.reshape(-1)
    valid = (flat >= 0) & (flat < capacity)
    idx = torch.where(valid, flat, 0).long()
    rows = torch.where(valid[:, None],
                       grad_out.float().repeat_interleave(f, dim=0), 0.0)
    gtable.index_add_(0, idx, rows)
    counts.index_add_(0, idx, valid.float())
    return gtable, counts


def gba_apply_ref(param: torch.Tensor, accum: torch.Tensor,
                  buffer: torch.Tensor, tokens: torch.Tensor, step: int,
                  lr: float, *, iota: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """param (N,) float32 or bfloat16, accum (N,) float32, buffer (M, N),
    tokens (M,) int32 -> new (param, accum), as new tensors.

    The arithmetic of the TPU kernel (``repro/kernels/gba_apply.py:80``),
    all in float32: the weights are ``keep / M`` with ``keep = (step -
    tokens) <= iota``, taken before the sum; ``g`` sums ``buffer[j] *
    w[j]`` one slot after another from slot 0; then ``a' = accum + g * g``
    and ``p' = p - (lr * g) / (sqrt(a') + EPS)``, and ``p'`` is cast back
    to the param's dtype.  (``repro.kernels.ref.gba_apply_ref`` divides
    the kept sum by M after summing, which rounds differently for an M
    that is not a power of two; the kernels do not.)  Every step is one
    correctly rounded float32 operation in a fixed order, on the CPU and
    on the card alike, so the CUDA kernel is held to this bit for bit.

    The square root is taken in float64 and rounded once to float32:
    ``torch.sqrt`` of a float32 CPU tensor goes through MKL's vector math,
    which misses the correctly rounded result on about 0.7 % of inputs,
    while the float64 root rounded to float32 is the correctly rounded
    float32 root (a float32 root never lies within a float64 ulp of a
    float32 rounding boundary) on the CPU and on the card."""
    m = buffer.shape[0]
    w = ((step - tokens) <= iota).float() / m
    g = buffer[0].float() * w[0]
    for j in range(1, m):
        g = g + buffer[j].float() * w[j]
    a = accum + g * g
    root = torch.sqrt(a.double()).float()
    p = param.float() - (lr * g) / (root + EPS)
    return p.to(param.dtype), a
