"""GBA's Eq. (1) decayed mean of an (M, D) gradient buffer: a hand-written
CUDA kernel for Hopper.

Counterpart of ``repro.kernels.gba_aggregate``.  The kernel is
``csrc/gba_aggregate.cu``; its header says what it replaces and what
bounds it.  It is bound with ``ctypes`` and built at first use
(``repro_torch.kernels.runtime``).  The pytree GBA path launches it once
per leaf through ``ops.gba_aggregate_tree``; the fused flat-buffer path
uses ``gba_apply``, which fuses the same sum with the Adagrad update.

:func:`gba_aggregate` dispatches on the device of its tensors and on
nothing else: CPU tensors take the plain version ``repro_torch.kernels.
ref.gba_aggregate_ref``, CUDA tensors launch the kernel or raise.
``gba_aggregate.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.gba_apply import VEC, apply_smem_bytes
from repro_torch.kernels.launch_meta import (HOPPER, DeviceLimits,
                                             LaunchMeta, OperandMeta,
                                             SmemMeta, grid_stride)
from repro_torch.kernels.ref import gba_aggregate_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLOTS = 4096          # the weights live in shared memory, 4 B a slot


@functools.cache
def _aggregate():
    fn = runtime.load_library("gba_aggregate").repro_gba_aggregate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gba_aggregate(grads: torch.Tensor, tokens: torch.Tensor, step: int, *,
                  iota: int) -> torch.Tensor:
    """grads (M, D) float32 or bfloat16, tokens (M,) int32 -> the decayed
    mean (D,) in the buffer's dtype, a new tensor.  Slot j is kept when
    ``step - tokens[j] <= iota`` and weighs ``1 / M`` (the divisor is M,
    not the count of kept slots); the arithmetic is
    :func:`gba_aggregate_ref`'s."""
    if grads.dim() != 2 or tokens.shape != (grads.shape[0],):
        raise ValueError(f"expected grads (M, D) and tokens (M,), got "
                         f"{tuple(grads.shape)} and {tuple(tokens.shape)}")
    if grads.dtype not in _DTYPE_CODE:
        raise TypeError(f"grads must be float32 or bfloat16, got "
                        f"{grads.dtype}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, got {tokens.dtype}")
    if not 1 <= grads.shape[0] <= _MAX_SLOTS:
        raise ValueError(f"M = {grads.shape[0]} slots; the kernel takes 1 to "
                         f"{_MAX_SLOTS}")
    step, iota = operator.index(step), operator.index(iota)
    if grads.device.type == "cpu" and tokens.device.type == "cpu":
        with runtime.plain_region("gba_aggregate"):
            return gba_aggregate_ref(grads, tokens, step, iota=iota)
    if grads.device.type != "cuda" or tokens.device != grads.device:
        raise ValueError(f"grads and tokens must both lie on the CPU or on "
                         f"one CUDA device, got {grads.device} and "
                         f"{tokens.device}")
    if not (grads.is_contiguous() and tokens.is_contiguous()):
        raise ValueError("grads and tokens must be contiguous")
    m, d = grads.shape
    out = torch.empty((d,), dtype=grads.dtype, device=grads.device)
    if d == 0:
        return out
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _aggregate()(grads.data_ptr(), _DTYPE_CODE[grads.dtype],
                           tokens.data_ptr(), out.data_ptr(), m, d, step,
                           iota, stream)
    runtime.check(err, "gba_aggregate kernel launch")
    gba_aggregate.launches += 1
    return out


gba_aggregate.launches = 0


def launch_meta(d: int, m: int, dtype=torch.float32, *, aligned: bool = True,
                limits: DeviceLimits = HOPPER) -> LaunchMeta:
    """The launch ``csrc/gba_aggregate.cu`` makes for an (M, D) buffer:
    ``gba_apply``'s grid-stride geometry and M float32 weights of shared
    memory, 4 columns an access where D is a multiple of 4 and the buffer
    and output are 16-byte aligned (``aligned``), else one.  D is a
    64-bit argument, ``m`` an ``int``."""
    vec = VEC if aligned and d % VEC == 0 else 1
    cols = dict(vec=vec, walk=d // vec * vec)
    return grid_stride(
        "gba_aggregate", f"({m}, {d}) {str(dtype)[6:]}"
        f"{'' if aligned else ' unaligned'}", d, vec, limits.sms, (
            OperandMeta("grads", (m, d), dtype, **cols),
            OperandMeta("tokens", (m,), torch.int32),
            OperandMeta("out", (d,), dtype, **cols)),
        dynamic_smem=(SmemMeta("weights", apply_smem_bytes(m)),),
        declared_smem_bytes=apply_smem_bytes(m), smem_counted=("weights",),
        int_args={"m": m})
