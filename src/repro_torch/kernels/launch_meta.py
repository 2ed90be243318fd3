"""Static launch geometry of the Hopper kernels.

Counterpart of ``repro.kernels.launch_meta``.  Every kernel wrapper of
this package describes each CUDA launch it makes as a :class:`LaunchMeta`,
built by a ``*launch_meta()`` function beside the wrapper: the grid and
the block, the named shared-memory regions (dynamic and static), the
shared-memory formula the kernel declares and the regions it counts, the
operands with the tile a block touches and its index map, the width of
each access and of the element offsets, the Tensor Memory Accelerator's
tensor maps, the operands written in place, and whether the launch is
cooperative.  Where the geometry is planned in Python (``flash_decode``'s
``ring_plan`` and ``split_plan``, ``embedding_bag``'s ``grad_plan`` and
``resident_plan``) the meta is built from the same plan functions the
wrapper launches with; where it lives only in a source's host code (the
grid-stride kernels, ``quantize``, the ``embedding_bag`` forward) the meta
mirrors it, and ``chip_smoke.py`` holds the two equal on the card against
the launches ``torch.profiler`` records.

The static auditor (``repro_torch.analysis.launch_check``) checks a meta
against :class:`DeviceLimits` without building or launching anything:
vector and tensor-map legality (GBA-TILE-001), the declared shared memory
against its regions (GBA-VMEM-001), shared memory against a block's and
an SM's limits (GBA-VMEM-002), and the grid, the index maps and the index
widths against the device and the operands (GBA-GRID-001).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class DeviceLimits:
    """The limits a launch is checked against.  :data:`HOPPER` holds an
    H100 SXM's; ``chip_smoke.py`` passes the card's own values."""

    sms: int = 132
    max_threads_per_block: int = 1024
    max_block: tuple[int, int, int] = (1024, 1024, 64)
    max_grid: tuple[int, int, int] = (INT32_MAX, 65_535, 65_535)
    smem_per_block_optin: int = 232_448   # dynamic, after cudaFuncSetAttribute
    smem_per_sm: int = 233_472
    smem_reserved_per_block: int = 1_024  # CUDA's own, per resident block
    static_smem_max: int = 49_152         # __shared__ arrays of one kernel
    registers_per_sm: int = 65_536        # also the most a block may hold
    max_threads_per_sm: int = 2_048
    max_blocks_per_sm: int = 32
    tma_box_max: int = 256                # elements a box dimension holds
    tma_swizzle_span: int = 128           # bytes of the 128-byte swizzle


HOPPER = DeviceLimits()


@dataclass(frozen=True)
class SmemMeta:
    """One named shared-memory region of a block, in bytes."""

    name: str
    nbytes: int


@dataclass(frozen=True)
class OperandMeta:
    """One tensor a launch reads or writes.

    ``tile`` is the region of the operand one block touches and
    ``index_map(bx, by, bz)`` the tile's index (tile units, as a
    ``BlockSpec``'s) for block ``(bx, by, bz)``; both ``None`` where the
    block's region is not static (a gather by id, a search) or the kernel
    walks the operand in a grid-stride loop, whose elements a row per row
    visited are ``walk``.  The kernel masks the last, partial tile of the
    axes in ``ragged``.  ``vec`` values move in one access (1: scalar);
    element offsets into the operand are ``index_bits`` wide."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    tile: tuple[int, ...] | None = None
    index_map: Callable[..., tuple[int, ...]] | None = None
    ragged: tuple[int, ...] = ()
    vec: int = 1
    index_bits: int = 64
    walk: int | None = None

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()


@dataclass(frozen=True)
class TensorMapMeta:
    """A Tensor Memory Accelerator map: the global tensor's ``dims`` and
    byte ``strides`` (innermost first, one stride fewer than dims), the
    ``box`` a copy moves, the element size, the swizzle in bytes (0 for
    none), and ``span(bx, by, bz)``: the ``(start, end)`` elements of
    every dimension that block's boxes cover, innermost first."""

    name: str
    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]
    elem_bytes: int
    swizzle: int
    span: Callable[..., tuple[tuple[int, int], ...]]


@dataclass(frozen=True)
class LaunchMeta:
    """Complete static description of one CUDA launch.  ``at`` names the
    call's shape, so that the metas of one kernel at several shapes give
    distinct audit sites.  ``int_args`` are the launch's 32-bit ``int``
    arguments; ``blocks_per_sm`` the blocks of this launch its plan counts
    on being resident on an SM at once (None: no such plan)."""

    kernel: str
    at: str
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    operands: tuple[OperandMeta, ...] = ()
    dynamic_smem: tuple[SmemMeta, ...] = ()
    static_smem: tuple[SmemMeta, ...] = ()
    declared_smem_bytes: int | None = None
    smem_counted: tuple[str, ...] = ()
    tensor_maps: tuple[TensorMapMeta, ...] = ()
    in_place: tuple[str, ...] = ()
    int_args: dict[str, int] = field(default_factory=dict)
    cooperative: bool = False
    blocks_per_sm: int | None = None

    @property
    def site(self) -> str:
        return f"{self.kernel}[{self.at}]"

    @property
    def threads(self) -> int:
        return math.prod(self.block)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def named_bytes(self) -> dict[str, int]:
        """Shared-memory bytes by region name, dynamic and static."""
        return {r.name: r.nbytes for r in self.dynamic_smem
                + self.static_smem}

    def smem_bytes(self, names: tuple[str, ...] | None = None) -> int:
        """Shared memory over ``names`` (default: every region);
        ``names=self.smem_counted`` is what the declared formula covers."""
        by_name = self.named_bytes()
        if names is None:
            return sum(by_name.values())
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(f"{self.kernel}: unknown regions {missing}")
        return sum(by_name[n] for n in names)

    def dynamic_smem_bytes(self) -> int:
        """The launch's dynamic shared memory: its third ``<<<>>>``
        argument."""
        return sum(r.nbytes for r in self.dynamic_smem)

    def static_smem_bytes(self) -> int:
        return sum(r.nbytes for r in self.static_smem)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stride_blocks(elements: int, threads: int, sms: int) -> int:
    """Blocks of a grid-stride launch (``gba_apply.cu``,
    ``gba_aggregate.cu``, ``fused_adagrad.cu``): one thread an access
    group, at most 16 blocks an SM; the loop strides over the rest."""
    return min(cdiv(elements, threads), 16 * sms)


def grid_stride(kernel: str, at: str, n: int, vec: int, sms: int,
                operands, **kw) -> LaunchMeta:
    """The meta of a grid-stride launch of 256 threads over ``n``
    columns, ``vec`` a thread an access."""
    return LaunchMeta(kernel, at, (stride_blocks(n // vec, 256, sms), 1, 1),
                      (256, 1, 1), tuple(operands), **kw)
