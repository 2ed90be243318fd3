"""One-token GQA decode attention over a KV cache: a hand-written CUDA
kernel for Hopper.

Counterpart of ``repro.kernels.flash_decode``.  The kernel is
``csrc/flash_decode.cu``; its header says what it replaces, what bounds it
and how it splits the cache across blocks.  It is bound with ``ctypes``
and built at first use (``repro_torch.kernels.runtime``).  The LM decode
step launches it once a layer through ``ops.flash_decode`` when the cache
position is one scalar for the whole batch (``models.layers.
attention_decode``; the fixed-batch loop of ``launch.serve``).

:func:`flash_decode` dispatches on the device of its tensors and on
nothing else: CPU tensors take the plain version ``repro_torch.kernels.
ref.flash_decode_ref``, CUDA tensors launch the kernel or raise.
``flash_decode.launches`` counts the kernel launches of this process (one
a call: the split pass and the combine pass together).
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import flash_decode_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)   # the head dims the kernel is built for
MAX_GROUP = 8                # query heads per KV head a block holds
STAGE_BYTES = 16384          # of K (and of V) a block stages per tile
# split blocks resident on an SM at once: 64 KB of stages each, of 227 KB
BLOCKS_PER_SM = 3


@functools.cache
def _decode():
    fn = runtime.load_library("flash_decode").repro_flash_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(length: int, rows: int, sms: int, tile: int
               ) -> tuple[int, int]:
    """``(chunk, nsplit)``: the cache positions each block walks (a multiple
    of the kernel's ``tile`` of positions) and the blocks per (b, kv) row.
    The ``rows`` (B * KV) rows get as many splits as fit one wave of
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs (at least one), so
    that every resident block walks an equal share."""
    want = max(1, BLOCKS_PER_SM * sms // rows)
    chunk = -(-length // want)
    chunk = -(-chunk // tile) * tile
    return chunk, -(-length // chunk)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, KV, G, hd) and k, v (B, L, KV, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, kv, g, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kv, hd) or k.shape[1] < 1:
        raise ValueError(f"k and v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}: expected ({b}, L >= 1, {kv}, "
                         f"{hd})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k and v must share one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head: the kernel takes 1 "
                         f"to {MAX_GROUP}")
    if b < 1 or kv < 1 or k.shape[1] >= 2**31:
        raise ValueError(f"empty batch or heads, or L = {k.shape[1]} >= "
                         f"2**31: {tuple(q.shape)}, {tuple(k.shape)}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int | torch.Tensor) -> torch.Tensor:
    """q (B, KV, G, hd), k and v (B, L, KV, hd), one dtype (float32 or
    bfloat16); ``pos`` the last valid cache index, an int or a 0-d integer
    tensor on q's device -> (B, KV, G, hd) in q's dtype, a new tensor.
    Every position ``idx > pos`` is masked; the arithmetic is
    :func:`flash_decode_ref`'s, summed in another order.

    The kernel takes hd in ``HEAD_DIMS`` (64, 128, 256), G from 1 to
    ``MAX_GROUP`` (8), any L from 1 to 2**31 - 1 (a partial last tile is
    masked), and contiguous tensors, k and v on 16-byte boundaries; the
    wrapper refuses anything else on either device (the boundary on the
    card only).  A ``pos`` tensor stays on the card: the kernel reads it
    there, so a decode loop needs no host round trip."""
    _check(q, k, v)
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype.is_floating_point or \
                pos.dtype == torch.bool:
            raise TypeError(f"pos must be a 0-d integer tensor, got "
                            f"{pos.dtype} of shape {tuple(pos.shape)}")
    else:
        pos = operator.index(pos)
    on = {t.device for t in (q, k, v)}
    if isinstance(pos, torch.Tensor):
        on.add(pos.device)
    if on == {torch.device("cpu")}:
        return flash_decode_ref(q, k, v, pos)
    if len(on) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v and a pos tensor must all lie on the CPU "
                         f"or on one CUDA device, got {sorted(map(str, on))}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, kv, g, hd = q.shape
    length = k.shape[1]
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary (the "
                         "kernel copies them in 16-byte pieces)")
    dev = q.device
    pos_t = (pos.to(torch.int32) if isinstance(pos, torch.Tensor) else
             torch.full((), pos, dtype=torch.int32, device=dev))
    tile = STAGE_BYTES // (hd * q.element_size())
    chunk, nsplit = split_plan(length, b * kv, _sm_count(dev.index or 0),
                               tile)
    part_m = torch.empty((b, kv, nsplit, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, nsplit, g, hd), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _decode()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        _DTYPE_CODE[q.dtype], pos_t.data_ptr(),
                        part_m.data_ptr(), part_l.data_ptr(),
                        part_acc.data_ptr(), out.data_ptr(), b, length, kv,
                        g, hd, chunk, nsplit, stream)
    runtime.check(err, "flash_decode kernel launch")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
