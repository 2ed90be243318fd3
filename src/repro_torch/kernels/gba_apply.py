"""GBA's fused decay-aggregate and Adagrad apply: a hand-written CUDA
kernel for Hopper.

Counterpart of ``repro.kernels.gba_apply``.  The kernel is
``csrc/gba_apply.cu``; its header says what it replaces and what bounds
it.  It is bound with ``ctypes`` and built at first use
(``repro_torch.kernels.runtime``).

:func:`gba_apply` dispatches on the device of its tensors and on nothing
else: CPU tensors take the plain version ``repro_torch.kernels.ref.
gba_apply_ref``, CUDA tensors launch the kernel or raise.  Either way
``param`` and ``accum`` are updated in place, as the TPU kernel aliases
them to its outputs.  ``gba_apply.launches`` counts the kernel launches of
this process.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.launch_meta import (HOPPER, INT32_MAX, DeviceLimits,
                                             LaunchMeta, OperandMeta,
                                             SmemMeta, grid_stride)
from repro_torch.kernels.ref import EPS, gba_apply_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLOTS = 4096          # the weights live in shared memory, 4 B a slot
VEC = 4                    # columns a thread moves an access where aligned


@functools.cache
def _apply():
    fn = runtime.load_library("gba_apply").repro_gba_apply
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(param, accum, buffer, tokens) -> None:
    if param.dim() != 1 or accum.shape != param.shape or (
            buffer.dim() != 2 or buffer.shape[1] != param.shape[0]) or (
            tokens.shape != (buffer.shape[0],)):
        raise ValueError(
            f"expected param (N,), accum (N,), buffer (M, N), tokens (M,); "
            f"got {tuple(param.shape)}, {tuple(accum.shape)}, "
            f"{tuple(buffer.shape)}, {tuple(tokens.shape)}")
    if param.dtype not in _DTYPE_CODE or buffer.dtype not in _DTYPE_CODE:
        raise TypeError(f"param and buffer must be float32 or bfloat16, got "
                        f"{param.dtype} and {buffer.dtype}")
    if accum.dtype != torch.float32:
        raise TypeError(f"accum must be float32, got {accum.dtype}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, got {tokens.dtype}")
    if not 1 <= buffer.shape[0] <= _MAX_SLOTS:
        raise ValueError(f"M = {buffer.shape[0]} slots; the kernel takes 1 "
                         f"to {_MAX_SLOTS}")
    if param.shape[0] > INT32_MAX:
        raise ValueError(f"N = {param.shape[0]} does not fit in int32")


def gba_apply(param: torch.Tensor, accum: torch.Tensor,
              buffer: torch.Tensor, tokens: torch.Tensor, step: int,
              lr: float, *, iota: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass decay-aggregate + Adagrad apply, in place.

    param (N,) float32 or bfloat16, accum (N,) float32, buffer (M, N)
    float32 or bfloat16, tokens (M,) int32; ``step``, ``iota`` ints and
    ``lr`` a float; epsilon is ``ref.EPS``.  Slot j is kept when ``step - tokens[j] <=
    iota`` and weighs ``1 / M`` (the divisor is M, not the count of kept
    slots).  Writes the new param and accum into ``param`` and ``accum``
    and returns them; the arithmetic is :func:`gba_apply_ref`'s."""
    _check(param, accum, buffer, tokens)
    step, iota = operator.index(step), operator.index(iota)
    lr = float(lr)
    tensors = (param, accum, buffer, tokens)
    if all(t.device.type == "cpu" for t in tensors):
        with runtime.plain_region("gba_apply"):
            new_p, new_a = gba_apply_ref(param, accum, buffer, tokens, step,
                                         lr, iota=iota)
            param.copy_(new_p)
            accum.copy_(new_a)
        return param, accum
    if param.device.type != "cuda" or any(t.device != param.device
                                          for t in tensors):
        raise ValueError(f"param, accum, buffer and tokens must all lie on "
                         f"the CPU or on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("param, accum, buffer and tokens must be contiguous")
    m, n = buffer.shape
    if n == 0:
        return param, accum
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _apply()(param.data_ptr(), _DTYPE_CODE[param.dtype],
                       accum.data_ptr(), buffer.data_ptr(),
                       _DTYPE_CODE[buffer.dtype], tokens.data_ptr(), m, n,
                       step, iota, lr, EPS, stream)
    runtime.check(err, "gba_apply kernel launch")
    gba_apply.launches += 1
    return param, accum


gba_apply.launches = 0


def apply_smem_bytes(m: int) -> int:
    """The kernel's dynamic shared memory: the M decay weights, float32."""
    return m * 4


def launch_meta(n: int, m: int, param_dtype=torch.float32,
                buffer_dtype=torch.float32, *, aligned: bool = True,
                limits: DeviceLimits = HOPPER) -> LaunchMeta:
    """The launch ``csrc/gba_apply.cu`` makes for an (N,) param and an
    (M, N) buffer: 256 threads a block over a grid-stride loop, 4 columns
    an access where N is a multiple of 4 and every row is 16-byte aligned
    (``aligned``; PyTorch's own allocations are), else one.  Param and
    accumulator are updated in place; ``n`` and ``m`` are ``int``
    arguments."""
    vec = VEC if aligned and n % VEC == 0 else 1
    walk = n // vec * vec
    cols = dict(vec=vec, walk=walk)
    return grid_stride(
        "gba_apply", f"({m}, {n}) {str(param_dtype)[6:]}/"
        f"{str(buffer_dtype)[6:]}{'' if aligned else ' unaligned'}",
        n, vec, limits.sms, (
            OperandMeta("param", (n,), param_dtype, **cols),
            OperandMeta("accum", (n,), torch.float32, **cols),
            OperandMeta("buffer", (m, n), buffer_dtype, **cols),
            OperandMeta("tokens", (m,), torch.int32)),
        dynamic_smem=(SmemMeta("weights", apply_smem_bytes(m)),),
        declared_smem_bytes=apply_smem_bytes(m), smem_counted=("weights",),
        in_place=("param", "accum"), int_args={"m": m, "n": n})
