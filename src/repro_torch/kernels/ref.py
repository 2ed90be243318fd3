"""Plain PyTorch versions of the kernels.

The CPU tests hold them against the JAX package, the wrappers use them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

import math

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


def gba_aggregate_ref(buffer: torch.Tensor, tokens: torch.Tensor,
                      step: int, *, iota: int,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """buffer (M, D) float32 or bfloat16, tokens (M,) int32 -> the Eq. (1)
    decayed mean (D,) in ``dtype`` (default: the buffer's), as a new
    tensor.

    The arithmetic of the TPU kernel (``repro/kernels/gba_aggregate.py:63``)
    as XLA computes it on the CPU, in float32: the weights are ``keep / M``
    with ``keep = (step - tokens) <= iota``, taken before the sum (the
    divisor is M, not the count of kept slots); from ``g = +0.0``, ``g =
    fma(buffer[j], w[j], g)`` one slot after another (so a column whose
    products are all -0.0 sums to +0.0, as XLA's reduction does); ``g`` is
    rounded once to ``dtype``.  At M = 1 XLA drops the reduction and
    returns the product, whose zero keeps its sign: the sum then starts
    from -0.0, which ``fma(b, w, -0.0)`` leaves equal to ``b * w``.  (``repro.kernels.ref.gba_aggregate_ref`` divides
    the kept sum by M after summing, which rounds differently for an M
    that is not a power of two; the kernels do not.)  The same sum with
    the products rounded separately differs from the kernel.  Bit for bit
    the Pallas kernel's up to M = 16; at M = 100 XLA adds the slots in
    another order."""
    m = buffer.shape[0]
    w = ((step - tokens) <= iota).float() / m
    g = torch.full(buffer.shape[1:], -0.0 if m == 1 else 0.0,
                   dtype=torch.float32, device=buffer.device)
    for j in range(m):
        g = fma_f32(buffer[j].float(), w[j], g)
    return g.to(dtype or buffer.dtype)


def fused_adagrad_ref(param: torch.Tensor, grad: torch.Tensor,
                      accum: torch.Tensor, lr: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """param (N,) float32 or bfloat16, grad (N,) float32 or bfloat16, accum
    (N,) float32 -> new (param, accum), as new tensors.

    The TPU kernel's update (``repro/kernels/fused_adagrad.py:64``) as XLA
    computes it on the CPU, in float32: ``a' = fma(g, g, accum)`` (XLA
    fuses ``accum + g * g``) and ``p' = p - (lr * g) / (sqrt(a') + EPS)``,
    ``p'`` cast back to the param's dtype.  Every step is one correctly
    rounded operation in a fixed order, on the CPU and on the card alike.

    The square root is taken in float64 and rounded once to float32:
    ``torch.sqrt`` of a float32 CPU tensor goes through MKL's vector math,
    which misses the correctly rounded result on about 0.7 % of inputs,
    while the float64 root rounded to float32 is the correctly rounded
    float32 root (a float32 root never lies within a float64 ulp of a
    float32 rounding boundary) on the CPU and on the card."""
    g = grad.float()
    a = fma_f32(g, g, accum)
    root = torch.sqrt(a.double()).float()
    p = param.float() - (lr * g) / (root + EPS)
    return p.to(param.dtype), a


def gba_apply_ref(param: torch.Tensor, accum: torch.Tensor,
                  buffer: torch.Tensor, tokens: torch.Tensor, step: int,
                  lr: float, *, iota: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """param (N,) float32 or bfloat16, accum (N,) float32, buffer (M, N),
    tokens (M,) int32 -> new (param, accum), as new tensors.

    The arithmetic of the TPU kernel (``repro/kernels/gba_apply.py:80``)
    as XLA computes it on the CPU: :func:`gba_aggregate_ref`'s decayed sum
    ``g`` kept in float32, then :func:`fused_adagrad_ref`'s update with it.
    (``repro.kernels.ref.gba_apply_ref`` divides the kept sum by M after
    summing, which rounds differently for an M that is not a power of two;
    the kernels do not.)  The CUDA kernel is held to this bit for bit."""
    g = gba_aggregate_ref(buffer, tokens, step, iota=iota,
                          dtype=torch.float32)
    return fused_adagrad_ref(param, g, accum, lr)


# elements per float64 pass of fma_f32: its temporaries stay near 1 GB on
# the card at the full-width shapes
_FMA_CHUNK = 1 << 25


def _fma_exact(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    p = a.double() * b.double()       # exact: two 24-bit significands
    c = c.double()
    s = p + c
    v = s - p                         # TwoSum: s + e == p + c exactly
    e = (p - (s - v)) + (c - v)
    # round to odd: an inexact sum takes, of the two float64 values around
    # p + c, the one whose last bit is 1; rounding that to float32 rounds
    # p + c once, since float64 keeps more than two bits beyond float32's
    odd = (s.view(torch.int64) & 1) == 1
    away = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((e != 0) & ~odd, torch.nextafter(s, away), s)
    return s.float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn`` computes it and
    as XLA fuses it on the CPU.  The product of two float32 values is
    exact in float64; the sum is rounded to odd in float64 and then to
    float32, which is the correctly rounded result (a plain float64 sum
    rounded twice would miss it where the first rounding lands on a
    float32 tie).  Broadcasts like ``a * b + c``; computed in chunks of
    the leading axis."""
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    a, b, c = (t.expand(shape) for t in (a, b, c))
    out = torch.empty(shape, dtype=torch.float32, device=c.device)
    step = max(1, _FMA_CHUNK // max(1, math.prod(shape[1:])))
    for i in range(0, shape[0], step):
        out[i:i + step] = _fma_exact(a[i:i + step], b[i:i + step],
                                     c[i:i + step])
    return out


# the minmax scale multiplies by the float32 reciprocal of 255, as XLA
# computes the reference's ``(mx - mn) / 255.0`` on the CPU (a division by
# a constant becomes a product by its reciprocal): ``(mx - mn) / 255``
# differs from it by one ulp on some tiles
INV_255 = torch.tensor(1 / 255, dtype=torch.float32).item()
# the sign scale's lanes: lane t of a tile sums |x[t]|, |x[t + 256]|, ...
SIGN_LANES = 256


def _tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    r, c = x.shape
    if tile < 1 or c % tile:
        raise ValueError(f"payload columns {c} not a multiple of tile {tile}")
    return x.float().reshape(r, c // tile, tile)


def _min_signed(x: torch.Tensor) -> torch.Tensor:
    """min over the last axis with -0.0 below +0.0, as the reference's
    reduction ranks them (``torch.amin`` may return either zero)."""
    mn = torch.amin(x, dim=-1)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim=-1)
    return torch.where((mn == 0) & neg_zero, torch.full_like(mn, -0.0), mn)


def quantize_minmax_ref(payload: torch.Tensor, tile: int
                        ) -> tuple[torch.Tensor, ...]:
    """payload (R, C) float32, C a ``tile`` multiple -> ``(q int8 (R, C),
    scale (R, C/tile), zero (R, C/tile), residual (R, C))``, as new
    tensors.

    Per (row, tile) slice x: ``mn = min x`` (-0.0 ranks below +0.0),
    ``scale = (max x - mn) * INV_255`` (0 for a constant tile), ``code =
    clamp(round((x - mn) / safe), 0, 255)`` with ``safe = scale`` where
    ``scale > 0``, else 1, and round half to even; ``q = code - 128``,
    ``zero = mn``, and ``residual = x - fma(code, scale, mn)``, which is
    ``x - dequantize_ref(q)`` exactly.  The arithmetic of the TPU kernel
    (``repro/kernels/quantize.py:131``) as XLA runs it on the CPU."""
    x = _tiles(payload, tile)
    mn = _min_signed(x)
    scale = (torch.amax(x, dim=-1) - mn) * INV_255
    safe = torch.where(scale > 0, scale, 1.0)
    code = torch.clamp(torch.round((x - mn[..., None]) / safe[..., None]),
                       0.0, 255.0)
    res = x - fma_f32(code, scale[..., None], mn[..., None])
    return ((code - 128).to(torch.int8).reshape(payload.shape), scale, mn,
            res.reshape(payload.shape))


def _sign_scale(x: torch.Tensor) -> torch.Tensor:
    """float32 mean |x| over the last axis (length ``tile``), summed in
    float64 in the kernel's order: lane t of ``SIGN_LANES`` adds |x[t]|,
    |x[t + 256]|, ... one after another from 0.0, then lane t adds lane
    t + s for s = 128, 64, ..., 1; the sum is divided by ``tile`` in
    float64 and rounded once to float32."""
    tile = x.shape[-1]
    a = x.abs().double()
    pad = -tile % SIGN_LANES
    if pad:                  # lanes past the tile's end add +0.0
        a = torch.nn.functional.pad(a, (0, pad))
    a = a.reshape(*x.shape[:-1], -1, SIGN_LANES)
    lanes = a[..., 0, :]
    for k in range(1, a.shape[-2]):
        lanes = lanes + a[..., k, :]
    s = SIGN_LANES
    while s > 1:
        s //= 2
        lanes = lanes[..., :s] + lanes[..., s:2 * s]
    return (lanes[..., 0] / tile).float()


def quantize_sign_ref(payload: torch.Tensor, tile: int
                      ) -> tuple[torch.Tensor, ...]:
    """payload (R, C) float32 -> ``(q int8 (R, C), scale (R, C/tile),
    residual (R, C))``: ``q = +1`` where ``x >= 0`` (-0.0 included), else
    -1; ``scale`` the tile's mean |x| (:func:`_sign_scale`); ``residual =
    x - q * scale``.  The reference (``repro/kernels/quantize.py:149``)
    takes the mean in XLA's reduction order, which no fixed order here
    reproduces: its scale is within 2 ulps of this one."""
    x = _tiles(payload, tile)
    scale = _sign_scale(x)
    q = torch.where(x >= 0, 1.0, -1.0)
    res = x - q * scale[..., None]
    return (q.to(torch.int8).reshape(payload.shape), scale,
            res.reshape(payload.shape))


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor | None, tile: int, mode: str
                   ) -> torch.Tensor:
    """q (R, C) int8 and its (R, C/tile) sidebands -> (R, C) float32:
    ``fma(q + 128, scale, zero)`` for ``"minmax"``, ``q * scale`` for
    ``"sign"`` (``repro/kernels/quantize.py:160`` and ``:167``)."""
    code = _tiles(q, tile)
    if mode == "minmax":
        out = fma_f32(code + 128, scale[..., None], zero[..., None])
    elif mode == "sign":
        out = code * scale[..., None]
    else:
        raise ValueError(f"unknown dequantize mode {mode!r}")
    return out.reshape(q.shape)


# cache positions per online-softmax block of the TPU kernel
# (``repro/kernels/flash_decode.py``: BLOCK_L)
FLASH_BLOCK_L = 512
# the TPU kernel's mask value and the online softmax's starting maximum
FLASH_MASK = -1e30


def _flash_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: int | torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's body block by block (see :func:`flash_decode_ref`):
    ``(acc / l, m + log(l))``, both float32."""
    b, kv, g, hd = q.shape
    length = k.shape[1]
    blk = min(FLASH_BLOCK_L, length)
    qf = q.float()
    # a 0-d tensor divisor: a true division on the card too, where dividing
    # by a Python float multiplies by its reciprocal
    scale = torch.full((), math.sqrt(hd), dtype=torch.float32,
                       device=q.device)
    m = torch.full((b, kv, g), FLASH_MASK, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((b, kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, length, blk):
        kb = k[:, start:start + blk].float()
        vb = v[:, start:start + blk].float()
        s = torch.einsum("bngh,blnh->bngl", qf, kb) / scale
        idx = start + torch.arange(kb.shape[1], device=q.device)
        s = torch.where(idx <= pos, s, FLASH_MASK)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngl,blnh->bngh", p, vb)
        m = m_new
    return acc / denom[..., None], m + torch.log(denom)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int | torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a KV cache: q (B, KV, G, hd), k and v
    (B, L, KV, hd), ``pos`` the last valid cache index (an int or a 0-d
    integer tensor) -> (B, KV, G, hd) in q's dtype.

    The TPU kernel's body (``repro/kernels/flash_decode.py:81-113``) block
    by block, in float32: blocks of ``FLASH_BLOCK_L`` positions (one block
    of L when L is smaller; a last partial block where L is not a multiple
    of it, which the TPU kernel refuses), scores ``(q . k) / sqrt(hd)``
    (a true division by ``sqrt(hd)`` rounded to float32), every position
    ``idx > pos`` set to ``FLASH_MASK`` (-1e30, not -inf), and the online
    softmax from ``m = FLASH_MASK``, ``l = 0``, ``acc = 0``: ``m' =
    max(m, max(s))``, ``alpha = exp(m - m')``, ``p = exp(s - m')``, ``l =
    l * alpha + sum(p)``, ``acc = acc * alpha + p @ v``.  The output is
    ``acc / l``, cast once.  A ``pos`` below 0 masks every position: all
    scores are equal and the output is the mean of v, as in the TPU
    kernel."""
    return _flash_online(q, k, v, pos)[0].to(q.dtype)


def flash_decode_partial_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, pos: int | torch.Tensor,
                             start: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_decode_ref` over one slice k, v of a longer sequence
    whose first position is ``start``, at the slice's local position
    ``pos - start``: ``(out, lse)``, both float32: out the unrounded
    ``acc / l``, lse (B, KV, G) the ``m + log(l)`` of the online softmax.
    A row with no position at or below the local position (it is
    negative) gives ``out = 0`` and ``lse = -inf`` in place of the mean
    of v, so that slices combine as ``sum_s exp(lse_s - M) out_s / sum_s
    exp(lse_s - M)``."""
    local = pos - start
    out, lse = _flash_online(q, k, v, local)
    empty = torch.as_tensor(local < 0, device=q.device)
    return torch.where(empty, 0.0, out), torch.where(empty, -math.inf, lse)
