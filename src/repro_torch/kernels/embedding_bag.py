"""Sum-pooled embedding lookup: a hand-written CUDA kernel for Hopper.

Counterpart of the forward of ``repro.kernels.embedding_bag``.  The kernel
is ``csrc/embedding_bag.cu`` (its header says what it replaces and what
bounds it), bound with ``ctypes`` and built at first use
(``repro_torch.kernels.runtime``).

:func:`embedding_bag` dispatches on the device of its tensors and on
nothing else: CPU tensors take :func:`~repro_torch.kernels.ref.embedding_bag_ref`,
CUDA tensors launch the kernel or raise.  ``embedding_bag.launches`` counts
the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import embedding_bag_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


@functools.cache
def _fwd():
    fn = runtime.load_library("embedding_bag").repro_embedding_bag_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def embedding_bag(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) int32, table: (V, D) float32 or bfloat16 -> pooled
    (B, D) in the table's dtype, summed in float32.  Ids outside ``[0, V)``
    add nothing; a pool of one id returns its row exactly."""
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"expected ids (B, F) and table (V, D), got "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if ids.device.type == "cpu" and table.device.type == "cpu":
        return embedding_bag_ref(ids, table)
    if ids.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"ids and table must both lie on the CPU or on one "
                         f"CUDA device, got {ids.device} and {table.device}")
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("ids and table must be contiguous")
    b, f = ids.shape
    v, d = table.shape
    if max(b * f, v, d) > _INT_MAX:
        raise ValueError(f"shape too large for int32 indexing: ids "
                         f"{tuple(ids.shape)}, table {tuple(table.shape)}")
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd()(ids.data_ptr(), table.data_ptr(), out.data_ptr(),
                     b, f, v, d, _DTYPE_CODE[table.dtype], stream)
    runtime.check(err, "embedding_bag kernel launch")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
