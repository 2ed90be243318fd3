"""Sum-pooled embedding lookup and its backward: hand-written CUDA kernels
for Hopper.

Counterpart of ``repro.kernels.embedding_bag``.  The kernels are
``csrc/embedding_bag.cu`` (the forward), ``csrc/embedding_bag_grad.cu``
(the segment sum of gradient rows with per-id counts: a tiled sum over
sorted ids for D > 0, and for D = 0 a sort-free counts kernel) and
``csrc/embedding_bag_grad_resident.cu`` (the same sum with each vocab
block's accumulator resident in shared memory: the JAX package's first
backward, kept as the oracle of the streamed one); each source's header
says what it replaces and what bounds it.  They are bound with ``ctypes``
and built at first use (``repro_torch.kernels.runtime``).

:func:`embedding_bag`, :func:`embedding_bag_grad` and
:func:`embedding_bag_grad_resident` dispatch on the device of their
tensors and on nothing else: CPU tensors take the plain versions of
``repro_torch.kernels.ref``, CUDA tensors launch the kernel or raise.
Each wrapper's ``.launches`` counts its kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ref import (embedding_bag_grad_ref,
                                     embedding_bag_ref)

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


SEGMENT_THREADS = 256          # threads a block of the D > 0 kernel
SEGMENT_TILE_BYTES = 16 * 1024  # table-gradient bytes a D > 0 block owns
COUNTS_THREADS = 256           # threads a block of the D = 0 kernel, one an SM
COUNTS_MAX_IDS = 1 << 24       # float32 sums of whole numbers exact up to it


def _check_counts(num_ids: int) -> None:
    """The counts contract on every device: at most ``COUNTS_MAX_IDS`` ids
    a call."""
    if num_ids > COUNTS_MAX_IDS:
        raise ValueError(f"{num_ids} ids: the counts kernel adds float32 "
                         f"ones, exact for up to {COUNTS_MAX_IDS} ids a call")


def _cover(capacity: int, tile_rows: int) -> int:
    return -(-capacity // tile_rows)


def _round4(n: int) -> int:
    return max(4, -(-n // 4) * 4)


@functools.cache
def _grad():
    lib = runtime.load_library("embedding_bag_grad")
    lib.repro_embedding_bag_grad.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.repro_embedding_bag_grad_counts.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.repro_embedding_bag_grad,
               lib.repro_embedding_bag_grad_counts):
        fn.restype = ctypes.c_int
    return lib


def grad_plan(capacity: int, d: int, sms: int
              ) -> tuple[str, int, int, int]:
    """``(design, threads, tile_rows, blocks)`` of one ``embedding_bag_grad``
    launch over ``capacity`` rows of width ``d`` on a card of ``sms`` SMs.
    Block ``b`` owns rows ``[b * tile_rows, (b + 1) * tile_rows)`` of ``[0,
    capacity)``; ``tile_rows`` is a multiple of 4 and no block is empty.

    D > 0 takes "segment": tiles of about ``SEGMENT_TILE_BYTES`` of table
    gradient.  D = 0 takes "counts", a cooperative launch of one block of
    ``COUNTS_THREADS`` threads an SM (fewer where there are fewer than 4
    rows an SM), each zeroing and then converting its own slice."""
    if d > 0:
        design, threads = "segment", SEGMENT_THREADS
        tile = max(4, SEGMENT_TILE_BYTES // (4 * d) // 4 * 4)
    else:
        design, threads = "counts", COUNTS_THREADS
        tile = _round4(_cover(capacity, max(1, min(sms,
                                                   _cover(capacity, 4)))))
    return design, threads, tile, _cover(capacity, tile)


@functools.lru_cache(maxsize=256)
def device_grad_plan(index: int, capacity: int, d: int
                     ) -> tuple[str, int, int, int]:
    """:func:`grad_plan` on CUDA device ``index``, with its SMs."""
    return grad_plan(capacity, d,
                     torch.cuda.get_device_properties(
                         index).multi_processor_count)


def sort_ids(ids: torch.Tensor, capacity: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat ids with every id outside ``[0, capacity)`` mapped to the
    sentinel ``capacity``, sorted stably: ``(sorted_ids (E,) int32,
    perm (E,) int64)``, ``sorted_ids = flat[perm]``.  The sort is
    PyTorch's, outside the kernel, as the JAX package sorts with XLA
    outside its Pallas kernel.  Only a gradient of width D > 0 needs it
    (its rows are summed in entry order); the counts alone (D = 0) are
    taken from the raw ids."""
    flat = ids.reshape(-1)
    keyed = torch.where((flat >= 0) & (flat < capacity), flat, capacity)
    return torch.sort(keyed, stable=True)


def embedding_bag_grad_sorted(sorted_ids: torch.Tensor, perm: torch.Tensor,
                              grad_out: torch.Tensor, capacity: int,
                              num_fields: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the D > 0 kernel on ids already sorted by :func:`sort_ids`;
    every tensor on one CUDA device and contiguous.  ``num_fields`` is F,
    so entry ``perm[e]`` belongs to batch row ``perm[e] // F``."""
    d = grad_out.shape[1]
    if d == 0:
        raise ValueError("grad_out of width 0: the counts alone come from "
                         "embedding_bag_grad_counts, on the raw ids")
    gtable = torch.empty((capacity, d), dtype=torch.float32,
                         device=grad_out.device)
    counts = torch.empty((capacity,), dtype=torch.float32,
                         device=grad_out.device)
    if capacity == 0:
        return gtable, counts
    e = sorted_ids.numel()
    _, threads, tile, blocks = device_grad_plan(grad_out.device.index,
                                                capacity, d)
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _grad().repro_embedding_bag_grad(
            sorted_ids.data_ptr(), perm.data_ptr(), grad_out.data_ptr(),
            gtable.data_ptr(), counts.data_ptr(), e, num_fields, capacity, d,
            threads, tile, blocks, stream)
    runtime.check(err, "embedding_bag_grad kernel launch")
    embedding_bag_grad.launches += 1
    return gtable, counts


def embedding_bag_grad_counts(ids: torch.Tensor, capacity: int
                              ) -> torch.Tensor:
    """Launch the D = 0 kernel on raw ids (any shape, int32, contiguous, on
    a CUDA device): ``(capacity,)`` float32 counts of the ids in ``[0,
    capacity)``, with no sort.  At most ``COUNTS_MAX_IDS`` ids a call, so
    that every count is exact."""
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if not 0 <= capacity <= _INT_MAX:
        raise ValueError(f"capacity {capacity} too large for int32 indexing")
    _check_counts(ids.numel())
    if ids.device.type != "cuda":
        raise ValueError(f"ids must lie on a CUDA device, got {ids.device}")
    counts = torch.empty((capacity,), dtype=torch.float32, device=ids.device)
    if capacity == 0:
        return counts
    _, threads, tile, blocks = device_grad_plan(ids.device.index, capacity,
                                                0)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _grad().repro_embedding_bag_grad_counts(
            ids.data_ptr(), counts.data_ptr(), ids.numel(), capacity,
            threads, tile, blocks, stream)
    runtime.check(err, "embedding_bag_grad (counts) kernel launch")
    embedding_bag_grad.launches += 1
    return counts


def _check_grad_args(ids: torch.Tensor, grad_out: torch.Tensor,
                     capacity: int) -> None:
    if ids.dim() != 2 or grad_out.dim() != 2 or (
            ids.shape[0] != grad_out.shape[0]):
        raise ValueError(f"expected ids (B, F) and grad_out (B, D), got "
                         f"{tuple(ids.shape)} and {tuple(grad_out.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out must be float32, got {grad_out.dtype}")
    b, f = ids.shape
    # the sentinel id is ``capacity`` itself, so it too must fit in int32
    if (not 0 <= capacity <= _INT_MAX
            or max(b * f, grad_out.shape[1]) > _INT_MAX):
        raise ValueError(f"shape too large for int32 indexing: ids "
                         f"{tuple(ids.shape)}, grad_out "
                         f"{tuple(grad_out.shape)}, capacity {capacity}")
    if not (ids.device.type == grad_out.device.type == "cpu") and (
            ids.device.type != "cuda" or ids.device != grad_out.device):
        raise ValueError(f"ids and grad_out must both lie on the CPU or on "
                         f"one CUDA device, got {ids.device} and "
                         f"{grad_out.device}")


def embedding_bag_grad(ids: torch.Tensor, grad_out: torch.Tensor,
                       capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ids: (B, F) int32, grad_out: (B, D) float32 -> (gtable (capacity, D),
    counts (capacity,)), both float32.  Entry ``(b, f)`` adds
    ``grad_out[b]`` to row ``ids[b, f]`` and 1 to its count; ids outside
    ``[0, capacity)`` add nothing.  Each row is summed in entry order, so
    the result is deterministic.  On a CUDA device a width D > 0 sorts the
    ids (:func:`sort_ids`) and launches the segment kernel; D = 0 asks for
    the counts alone and launches a counts kernel on the raw ids
    (:func:`embedding_bag_grad_counts`), with no sort: one launch either
    way.  D = 0 takes at most ``COUNTS_MAX_IDS`` ids a call on every
    device."""
    _check_grad_args(ids, grad_out, capacity)
    if grad_out.shape[1] == 0:
        _check_counts(ids.numel())
    if ids.device.type == "cpu":
        return embedding_bag_grad_ref(ids, grad_out, capacity)
    if grad_out.shape[1] == 0:
        counts = embedding_bag_grad_counts(ids.contiguous(), capacity)
        return torch.empty((capacity, 0), dtype=torch.float32,
                           device=ids.device), counts
    sorted_ids, perm = sort_ids(ids, capacity)
    return embedding_bag_grad_sorted(sorted_ids, perm,
                                     grad_out.contiguous(), capacity,
                                     ids.shape[1])


embedding_bag_grad.launches = 0


RESIDENT_BLOCK_V = 512      # vocab rows a block of the resident kernel owns
RESIDENT_MIN_CHUNK = 256    # entries a chunk holds at least (the TPU's)
RESIDENT_FEW_THREADS = 256  # threads a block when the blocks fill the card
RESIDENT_MAX_THREADS = 1024  # threads a block when they do not


def resident_smem_bytes(d: int, chunk: int) -> int:
    """Shared memory of a resident launch: the (512, D) float32
    accumulator, 512 int counts, 8 bytes a chunk entry (batch row, local
    row, run start), and 36 ints of warp totals and scalars.  The kernel's
    own sum is ``repro_embedding_bag_grad_resident_smem_bytes``; a card
    test holds the two equal."""
    return RESIDENT_BLOCK_V * d * 4 + RESIDENT_BLOCK_V * 4 + chunk * 8 + 36 * 4


def resident_max_d_for(smem_limit: int) -> int:
    """The widest D whose accumulator leaves room for a chunk of
    ``RESIDENT_MIN_CHUNK`` entries in ``smem_limit`` bytes."""
    return (smem_limit - resident_smem_bytes(0, RESIDENT_MIN_CHUNK)) // (
        RESIDENT_BLOCK_V * 4)


def resident_plan(capacity: int, d: int, smem_limit: int, sms: int
                  ) -> tuple[int, int, int]:
    """``(threads, chunk, smem bytes)`` of a resident launch over
    ``capacity`` rows of width ``d`` on a card of ``sms`` SMs whose blocks
    may use ``smem_limit`` bytes of shared memory.  Few vocab blocks (at
    most one an SM) get ``RESIDENT_MAX_THREADS`` threads each, so the
    one-block case spreads its runs over 32 warps; more get
    ``RESIDENT_FEW_THREADS``, so more blocks are resident at once.  The
    chunk (one entry a thread) is as many entries as the threads and the
    shared memory left by the accumulator allow, a multiple of 32."""
    if not 0 <= d <= resident_max_d_for(smem_limit):
        raise ValueError(f"D = {d}: the resident accumulator (512, D) "
                         f"float32 fits shared memory up to D = "
                         f"{resident_max_d_for(smem_limit)}; use "
                         f"embedding_bag_grad")
    blocks = -(-capacity // RESIDENT_BLOCK_V)
    threads = (RESIDENT_MAX_THREADS if blocks <= sms else
               RESIDENT_FEW_THREADS)
    room = (smem_limit - resident_smem_bytes(d, 0)) // 8 // 32 * 32
    chunk = min(threads, room)
    return threads, chunk, resident_smem_bytes(d, chunk)


@functools.cache
def _resident():
    lib = runtime.load_library("embedding_bag_grad_resident")
    fn = lib.repro_embedding_bag_grad_resident
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_embedding_bag_grad_resident_smem_limit.restype = ctypes.c_int
    return fn, lib.repro_embedding_bag_grad_resident_smem_limit


@functools.cache
def _resident_device(index: int) -> tuple[int, int]:
    """(shared memory limit, SMs) of CUDA device ``index``, read once."""
    with torch.cuda.device(index):
        limit = _resident()[1]()
    if limit <= 0:
        raise RuntimeError(f"reading the shared memory limit of CUDA device "
                           f"{index} failed")
    return limit, torch.cuda.get_device_properties(
        index).multi_processor_count


def resident_max_d() -> int:
    """The widest D whose (512, D) float32 accumulator fits the shared
    memory a block of the current CUDA device may use (111 on an H100)."""
    return resident_max_d_for(
        _resident_device(torch.cuda.current_device())[0])


def embedding_bag_grad_resident_sorted(sorted_ids: torch.Tensor,
                                       perm: torch.Tensor,
                                       grad_out: torch.Tensor, capacity: int,
                                       num_fields: int
                                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the resident kernel on ids already sorted by
    :func:`sort_ids`; every tensor on one CUDA device and contiguous, as
    :func:`embedding_bag_grad_sorted`.  Raises ``ValueError`` for a D above
    :func:`resident_max_d`."""
    d = grad_out.shape[1]
    limit, sms = _resident_device(grad_out.device.index)
    threads, chunk, _ = resident_plan(capacity, d, limit, sms)
    gtable = torch.empty((capacity, d), dtype=torch.float32,
                         device=grad_out.device)
    counts = torch.empty((capacity,), dtype=torch.float32,
                         device=grad_out.device)
    if capacity == 0:
        return gtable, counts
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _resident()[0](sorted_ids.data_ptr(), perm.data_ptr(),
                             grad_out.data_ptr(), gtable.data_ptr(),
                             counts.data_ptr(), sorted_ids.numel(),
                             num_fields, capacity, d, threads, chunk, stream)
    runtime.check(err, "embedding_bag_grad_resident kernel launch")
    embedding_bag_grad_resident.launches += 1
    return gtable, counts


def embedding_bag_grad_resident(ids: torch.Tensor, grad_out: torch.Tensor,
                                capacity: int
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The contract of :func:`embedding_bag_grad`, through the kernel that
    keeps each 512-row vocab block's accumulator resident in shared memory;
    the same sums in the same order, so the two agree bit for bit.  A CUDA
    call refuses a D above :func:`resident_max_d` with ``ValueError``; a
    CPU call takes the plain version at any D."""
    _check_grad_args(ids, grad_out, capacity)
    if ids.device.type == "cpu":
        return embedding_bag_grad_ref(ids, grad_out, capacity)
    sorted_ids, perm = sort_ids(ids, capacity)
    return embedding_bag_grad_resident_sorted(
        sorted_ids, perm, grad_out.contiguous(), capacity, ids.shape[1])


embedding_bag_grad_resident.launches = 0
