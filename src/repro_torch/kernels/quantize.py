"""Wire quantization of the worker-parallel PS step: hand-written CUDA
kernels for Hopper.

Counterpart of ``repro.kernels.quantize``.  The kernels are
``csrc/quantize.cu``; its header says what they replace and what bounds
them.  They are bound with ``ctypes`` and built at first use
(``repro_torch.kernels.runtime``).

:func:`quantize_minmax` and :func:`quantize_sign` take the float32
payload as a row-major (R, C) view with unit column stride (any leading
stride) and write the error-feedback residual back into it, in place; the
reference returns it as a new array.  :func:`dequantize` writes into the
``out`` view it is given.  Each dispatches on the device of its tensors and
on nothing else: CPU tensors take the plain versions in
``repro_torch.kernels.ref``, CUDA tensors launch the kernel or raise.
``<function>.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import operator

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.launch_meta import (INT32_MAX, LaunchMeta,
                                             OperandMeta, SmemMeta)
from repro_torch.kernels.ref import (INV_255, SIGN_LANES, dequantize_ref,
                                     quantize_minmax_ref, quantize_sign_ref)

_MODE_CODE = {"minmax": 0, "sign": 1}
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.cache
def _quantize():
    fn = runtime.load_library("quantize").repro_quantize
    fn.argtypes = [_P, _I64, _P, _I64, _P, _P, _I64, _I64, _I64, _INT, _INT,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dequantize():
    fn = runtime.load_library("quantize").repro_dequantize
    fn.argtypes = [_P, _I64, _P, _P, _I64, _P, _I64, _I64, _I64, _INT, _INT,
                   _P]
    fn.restype = ctypes.c_int
    return fn


def _rows(t: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str
          ) -> None:
    """``t`` is a (shape) ``dtype`` tensor whose rows are contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    if t.stride(1) != 1 and shape[1] > 1:
        raise ValueError(f"{what} must have unit column stride, got "
                         f"strides {t.stride()}")


def _geometry(x: torch.Tensor, tile: int) -> int:
    """The number of tiles a row of the (R, C) ``x`` holds; checks what
    the reference's ``_check_geometry`` checks and the grid's int32
    range."""
    tile = operator.index(tile)
    if x.dim() != 2:
        raise ValueError(f"expected an (R, C) tensor, got {tuple(x.shape)}")
    r, c = x.shape
    if tile < 1 or r < 1 or c < 1:
        raise ValueError(f"expected tile >= 1 and a non-empty payload, got "
                         f"tile {tile}, shape {tuple(x.shape)}")
    if c % tile:
        raise ValueError(f"payload columns {c} not a multiple of tile "
                         f"{tile}: the routing stage only quantizes "
                         f"tile-aligned group slices")
    if r * (c // tile) > INT32_MAX:
        raise ValueError(f"{r} x {c // tile} tiles exceed the kernel's "
                         f"int32 grid")
    return c // tile


def _on_one_card(tensors) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie
    on one CUDA device."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the tensors must all lie on the CPU or on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    return True


def _quantize_(x: torch.Tensor, tile: int, mode: str, ref, wrapper
               ) -> tuple[torch.Tensor, ...]:
    n_tiles = _geometry(x, tile)
    r, c = x.shape
    _rows(x, torch.float32, (r, c), "payload")
    if not _on_one_card([x]):
        with runtime.plain_region(f"quantize_{mode}"):
            *out, res = ref(x, tile)
            x.copy_(res)
        return tuple(out)
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    sides = [torch.empty((r, n_tiles), dtype=torch.float32, device=x.device)
             for _ in range(2 if mode == "minmax" else 1)]
    with torch.cuda.device(x.device):
        err = _quantize()(x.data_ptr(), x.stride(0), q.data_ptr(), c,
                          sides[0].data_ptr(), sides[-1].data_ptr(), n_tiles,
                          r, c, tile, _MODE_CODE[mode], INV_255,
                          torch.cuda.current_stream().cuda_stream)
    runtime.check(err, f"quantize_{mode} kernel launch")
    wrapper.launches += 1
    return (q, *sides)


def quantize_minmax(x: torch.Tensor, *, tile: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-max int8 quantize with error feedback, in place.

    x: (R, C) float32 payload, C a ``tile`` multiple, rows contiguous ->
    ``(q int8 (R, C), scale (R, C/tile), zero (R, C/tile))``, new
    contiguous tensors; ``x`` then holds the residual ``x -
    dequantize(q, scale, zero)``, exactly.  The arithmetic is
    :func:`~repro_torch.kernels.ref.quantize_minmax_ref`'s."""
    return _quantize_(x, tile, "minmax", quantize_minmax_ref,
                      quantize_minmax)


def quantize_sign(x: torch.Tensor, *, tile: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign (1-bit) quantize with a per-tile mean-|x| scale and error
    feedback, in place: x (R, C) float32 -> ``(q int8 of +-1 (R, C),
    scale (R, C/tile))``; ``x`` then holds the residual ``x - q *
    scale``.  The arithmetic is
    :func:`~repro_torch.kernels.ref.quantize_sign_ref`'s."""
    return _quantize_(x, tile, "sign", quantize_sign_ref, quantize_sign)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor | None, *, tile: int, mode: str,
               out: torch.Tensor) -> torch.Tensor:
    """Rebuild the float32 payload from the routed wire arrays into
    ``out`` and return it.

    q (R, C) int8; scale (and zero for ``mode="minmax"``) (R, C/tile)
    float32 with one leading stride; out (R, C) float32.  Every operand's
    rows are contiguous, with any leading stride.  The arithmetic is
    :func:`~repro_torch.kernels.ref.dequantize_ref`'s."""
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown dequantize mode {mode!r}")
    n_tiles = _geometry(q, tile)
    r, c = q.shape
    _rows(q, torch.int8, (r, c), "q")
    _rows(out, torch.float32, (r, c), "out")
    if mode == "minmax" and zero is None:
        raise ValueError("minmax dequantize needs the zero-point array")
    sides = [scale] if mode == "sign" else [scale, zero]
    for name, t in zip(("scale", "zero"), sides):
        _rows(t, torch.float32, (r, n_tiles), name)
        if t.stride(0) != scale.stride(0):
            raise ValueError("scale and zero must share their leading "
                             "stride")
    if not _on_one_card([q, out, *sides]):
        with runtime.plain_region("dequantize"):
            out.copy_(dequantize_ref(q, scale, zero, tile, mode))
        return out
    with torch.cuda.device(q.device):
        err = _dequantize()(q.data_ptr(), q.stride(0), scale.data_ptr(),
                            sides[-1].data_ptr(), scale.stride(0),
                            out.data_ptr(), out.stride(0), r, c, tile,
                            _MODE_CODE[mode],
                            torch.cuda.current_stream().cuda_stream)
    runtime.check(err, f"dequantize_{mode} kernel launch")
    dequantize.launches += 1
    return out


quantize_minmax.launches = 0
quantize_sign.launches = 0
dequantize.launches = 0


def _slices(r: int, c: int, tile: int, mode: str) -> tuple[int, tuple]:
    """``(n_tiles, operands)`` of a launch over the (r, c) payload: block
    ``i`` owns the (row, tile) slice ``(i // n_tiles, i % n_tiles)`` of
    each (r, c) operand and its word of each (r, n_tiles) sideband."""
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown quantize mode {mode!r}")
    if tile < 1 or c % tile:
        raise ValueError(f"payload columns {c} not a multiple of tile {tile}")
    n_tiles = c // tile

    def slice_of(i, *_):
        return (i // n_tiles, i % n_tiles)

    sides = ("scale", "zero") if mode == "minmax" else ("scale",)
    return n_tiles, {
        "payload": OperandMeta("payload", (r, c), torch.float32, (1, tile),
                               slice_of),
        "qvals": OperandMeta("qvals", (r, c), torch.int8, (1, tile),
                             slice_of),
        **{name: OperandMeta(name, (r, n_tiles), torch.float32, (1, 1),
                             slice_of) for name in sides}}


def quantize_launch_meta(r: int, c: int, tile: int, mode: str) -> LaunchMeta:
    """The launch ``csrc/quantize.cu``'s ``repro_quantize`` makes: ``r *
    c / tile`` blocks of ``SIGN_LANES`` threads, one (row, tile) slice a
    block, reduced in static shared memory (a float min and max a thread
    for minmax, a float64 sum a thread for sign).  The payload becomes the
    residual in place; ``tile`` is an ``int`` argument."""
    n_tiles, ops = _slices(r, c, tile, mode)
    static = ((SmemMeta("s_lo", SIGN_LANES * 4), SmemMeta("s_hi",
                                                          SIGN_LANES * 4))
              if mode == "minmax" else (SmemMeta("s_sum", SIGN_LANES * 8),))
    return LaunchMeta(f"quantize_{mode}", f"({r}, {c}) tile {tile}",
                      (r * n_tiles, 1, 1), (SIGN_LANES, 1, 1),
                      tuple(ops.values()), static_smem=static,
                      in_place=("payload",), int_args={"tile": tile})


def dequant_launch_meta(r: int, c: int, tile: int, mode: str) -> LaunchMeta:
    """The launch ``repro_dequantize`` makes: the quantize's grid and
    block, no shared memory, the float32 output in place of the
    payload."""
    n_tiles, ops = _slices(r, c, tile, mode)
    out = dataclasses.replace(ops.pop("payload"), name="out")
    return LaunchMeta(f"dequantize_{mode}", f"({r}, {c}) tile {tile}",
                      (r * n_tiles, 1, 1), (SIGN_LANES, 1, 1),
                      (*ops.values(), out), int_args={"tile": tile})
