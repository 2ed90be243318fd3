"""Fused Adagrad update, in place: a hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.fused_adagrad``.  The kernel is
``csrc/fused_adagrad.cu``; its header says what it replaces and what
bounds it.  It is bound with ``ctypes`` and built at first use
(``repro_torch.kernels.runtime``).  ``ops.adagrad_apply_tree`` launches it
once per leaf; the fused flat-buffer path uses ``gba_apply``, which fuses
the buffer's aggregation with the same update.

:func:`fused_adagrad` dispatches on the device of its tensors and on
nothing else: CPU tensors take the plain version ``repro_torch.kernels.
ref.fused_adagrad_ref``, CUDA tensors launch the kernel or raise.  Either
way ``param`` and ``accum`` are updated in place, as the TPU kernel
aliases them to its outputs.  ``fused_adagrad.launches`` counts the
kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.gba_apply import VEC
from repro_torch.kernels.launch_meta import (HOPPER, DeviceLimits,
                                             LaunchMeta, OperandMeta,
                                             grid_stride)
from repro_torch.kernels.ref import EPS, fused_adagrad_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _update():
    fn = runtime.load_library("fused_adagrad").repro_fused_adagrad
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_adagrad(param: torch.Tensor, grad: torch.Tensor,
                  accum: torch.Tensor, lr: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Adagrad step, in place.

    param (N,) float32 or bfloat16, grad (N,) float32 or bfloat16, accum
    (N,) float32; ``lr`` a float; epsilon is ``ref.EPS``.  Writes ``a' =
    fma(g, g, accum)`` into ``accum`` and ``p - (lr * g) / (sqrt(a') +
    EPS)`` into ``param`` and returns them; the arithmetic is
    :func:`fused_adagrad_ref`'s."""
    if param.dim() != 1 or grad.shape != param.shape or (
            accum.shape != param.shape):
        raise ValueError(f"expected param, grad and accum (N,), got "
                         f"{tuple(param.shape)}, {tuple(grad.shape)}, "
                         f"{tuple(accum.shape)}")
    if param.dtype not in _DTYPE_CODE or grad.dtype not in _DTYPE_CODE:
        raise TypeError(f"param and grad must be float32 or bfloat16, got "
                        f"{param.dtype} and {grad.dtype}")
    if accum.dtype != torch.float32:
        raise TypeError(f"accum must be float32, got {accum.dtype}")
    lr = float(lr)
    tensors = (param, grad, accum)
    if all(t.device.type == "cpu" for t in tensors):
        with runtime.plain_region("fused_adagrad"):
            new_p, new_a = fused_adagrad_ref(param, grad, accum, lr)
            param.copy_(new_p)
            accum.copy_(new_a)
        return param, accum
    if param.device.type != "cuda" or any(t.device != param.device
                                          for t in tensors):
        raise ValueError(f"param, grad and accum must all lie on the CPU or "
                         f"on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("param, grad and accum must be contiguous")
    n = param.shape[0]
    if n == 0:
        return param, accum
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _update()(param.data_ptr(), _DTYPE_CODE[param.dtype],
                        grad.data_ptr(), _DTYPE_CODE[grad.dtype],
                        accum.data_ptr(), n, lr, EPS, stream)
    runtime.check(err, "fused_adagrad kernel launch")
    fused_adagrad.launches += 1
    return param, accum


fused_adagrad.launches = 0


def launch_meta(n: int, param_dtype=torch.float32, grad_dtype=torch.float32,
                *, aligned: bool = True,
                limits: DeviceLimits = HOPPER) -> LaunchMeta:
    """The launch ``csrc/fused_adagrad.cu`` makes for (N,) tensors:
    ``gba_apply``'s grid-stride geometry with no shared memory, 4
    elements an access where N is a multiple of 4 and every array is
    aligned (``aligned``), else one.  Param and accumulator are updated in
    place; N is a 64-bit argument."""
    vec = VEC if aligned and n % VEC == 0 else 1
    cols = dict(vec=vec, walk=n // vec * vec)
    return grid_stride(
        "fused_adagrad", f"({n},) {str(param_dtype)[6:]}/"
        f"{str(grad_dtype)[6:]}{'' if aligned else ' unaligned'}",
        n, vec, limits.sms, (
            OperandMeta("param", (n,), param_dtype, **cols),
            OperandMeta("grad", (n,), grad_dtype, **cols),
            OperandMeta("accum", (n,), torch.float32, **cols)),
        in_place=("param", "accum"))
