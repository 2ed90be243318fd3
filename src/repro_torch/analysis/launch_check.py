"""Launch rule family: vector and tensor-map legality, shared memory, and
the grid against the device and the operands.

Counterpart of ``repro.analysis.pallas_check``, with each rule restated for
Hopper.  It reads the static :class:`repro_torch.kernels.launch_meta.
LaunchMeta` each kernel wrapper exports; nothing is built or launched, so
the checks run on the CPU, against :data:`~repro_torch.kernels.launch_meta.
HOPPER` or, on the card, against the card's own limits.

Calibration notes (what the rules deliberately allow):

* a block whose thread count is not a multiple of 32 is allowed where it is
  one thread a column of a whole row (a 1-D block as wide as the last
  dimension of an operand whose tile spans that row, scalar access):
  ``flash_decode``'s float32 combine at head dims 80 and 112.  Its last warp
  is partial by design; the kernel would otherwise guard every access.
* a tensor-map box may pass the end of a dimension by less than its own
  extent, where the Tensor Memory Accelerator fills zeros: the last tile of
  a split that ends past L, and at head dims 80 and 112 the last head's
  second box.  The boxes of the other heads reach into the next head's
  columns by design (``csrc/flash_decode.cu``, the cache map), in bounds,
  and are never read.  A box that starts past the end, or passes it by a
  whole box, is a finding.
* a tile on an axis the kernel masks (``OperandMeta.ragged``) may pass the
  end likewise; every other tile lies wholly inside its operand.
* shared memory counts the meta's regions: the static ones as the source
  declares them.  The compiler places static shared memory as it chooses
  (``-Xptxas -v`` reports it), so ``chip_smoke.py`` checks the card's launch
  with the compiler's number in place of the declared one.
"""
from __future__ import annotations

import itertools
import math

from repro_torch.analysis.rules import Finding, finding
from repro_torch.kernels.launch_meta import (HOPPER, INT32_MAX,
                                             DeviceLimits, LaunchMeta)

WARP = 32
SWIZZLES = (0, 32, 64, 128)
TMA_MAX_DIM = 2**32
TMA_MAX_STRIDE = 2**40


def _row_threads(meta: LaunchMeta) -> bool:
    """One thread a column of a whole row (the first calibration note)."""
    x, y, z = meta.block
    return y == z == 1 and any(
        op.tile is not None and op.vec == 1 and op.tile[-1] == op.shape[-1]
        == x for op in meta.operands)


def check_tiles(meta: LaunchMeta, site: str,
                limits: DeviceLimits = HOPPER) -> list[Finding]:
    """GBA-TILE-001: whole warps, whole vectors, legal tensor-map boxes."""
    out = []
    if meta.threads % WARP and not _row_threads(meta):
        out.append(finding("GBA-TILE-001", site,
                           f"{meta.kernel}: {meta.threads} threads a block "
                           f"{meta.block} are not whole warps"))
    for op in meta.operands:
        if op.vec == 1:
            continue
        nbytes = op.vec * op.itemsize
        if nbytes > 16 or nbytes & (nbytes - 1) or op.shape[-1] % op.vec:
            out.append(finding(
                "GBA-TILE-001", site,
                f"{meta.kernel}/{op.name}: {op.vec}-value accesses "
                f"({nbytes} B) do not divide rows of {op.shape[-1]} "
                f"{op.dtype} into whole vectors of at most 16 bytes"))
    for tm in meta.tensor_maps:
        inner = tm.box[0] * tm.elem_bytes
        bad = []
        if inner % 16:
            bad.append(f"inner box {inner} B is not a multiple of 16 B")
        if tm.swizzle not in SWIZZLES:
            bad.append(f"swizzle {tm.swizzle} B is none of {SWIZZLES}")
        elif tm.swizzle and inner > min(tm.swizzle, limits.tma_swizzle_span):
            bad.append(f"inner box {inner} B is wider than the "
                       f"{tm.swizzle}-byte swizzle span")
        if any(not 1 <= n <= limits.tma_box_max for n in tm.box):
            bad.append(f"box {tm.box} has a dimension outside 1 to "
                       f"{limits.tma_box_max}")
        if any(s % 16 or s >= TMA_MAX_STRIDE for s in tm.strides):
            bad.append(f"strides {tm.strides} B are not multiples of 16 "
                       f"below 2**40")
        if any(not 1 <= d <= TMA_MAX_DIM for d in tm.dims):
            bad.append(f"dims {tm.dims} outside 1 to 2**32")
        out += [finding("GBA-TILE-001", site,
                        f"{meta.kernel}/{tm.name}: {b}") for b in bad]
    return out


def check_smem(meta: LaunchMeta, site: str,
               limits: DeviceLimits = HOPPER) -> list[Finding]:
    """GBA-VMEM-001 (the declared formula equals its regions) and
    GBA-VMEM-002 (a block's and, where the plan counts on k blocks an SM,
    the SM's shared memory)."""
    out = []
    if meta.declared_smem_bytes is not None:
        counted = meta.smem_bytes(meta.smem_counted)
        if counted != meta.declared_smem_bytes:
            out.append(finding(
                "GBA-VMEM-001", site,
                f"{meta.kernel}: declared shared memory "
                f"{meta.declared_smem_bytes} B != {counted} B summed over "
                f"{list(meta.smem_counted)}: the formula drifted from the "
                f"launch"))
    static, total = meta.static_smem_bytes(), meta.smem_bytes()
    if static > limits.static_smem_max:
        out.append(finding("GBA-VMEM-002", site,
                           f"{meta.kernel}: {static} B of static shared "
                           f"memory exceed {limits.static_smem_max} B"))
    if total > limits.smem_per_block_optin:
        out.append(finding(
            "GBA-VMEM-002", site,
            f"{meta.kernel}: {total} B of shared memory "
            f"({ {k: v for k, v in meta.named_bytes().items() if v} }) "
            f"exceed the {limits.smem_per_block_optin} B a block may use"))
    k = meta.blocks_per_sm
    if k and k * (total + limits.smem_reserved_per_block) > limits.smem_per_sm:
        out.append(finding(
            "GBA-VMEM-002", site,
            f"{meta.kernel}: {k} blocks an SM of {total} B (+ "
            f"{limits.smem_reserved_per_block} B reserved each) exceed the "
            f"SM's {limits.smem_per_sm} B"))
    return out


def _grid_points(grid: tuple[int, ...], cap: int):
    if math.prod(grid) <= cap:
        return itertools.product(*(range(n) for n in grid))
    # huge grids: corners (and near-corners) catch off-by-one maps
    return itertools.product(*(sorted({0, min(1, n - 1), n - 1})
                               for n in grid))


def _outside(start: int, end: int, dim: int, step: int, ragged: bool) -> bool:
    """A region [start, end) of an axis of ``dim`` that is not inside it:
    it starts before 0 or at or past the end, or it passes the end where
    the axis is not ragged, or by ``step`` or more where it is.  An empty
    region (``step`` 0) lies anywhere."""
    return step > 0 and (start < 0 or start >= dim or (
        end > dim and (not ragged or end - dim >= step)))


def check_grid(meta: LaunchMeta, site: str, limits: DeviceLimits = HOPPER,
               max_points: int = 4096) -> list[Finding]:
    """GBA-GRID-001: the grid and block within the device's limits, every
    tile and tensor-map box inside its operand over the whole grid (corner
    sampling past ``max_points``), every grid-stride walk covering its
    rows, every element offset and ``int`` argument within its width, and
    a cooperative grid resident at once."""
    out = []

    def bad(detail: str) -> None:
        out.append(finding("GBA-GRID-001", site, f"{meta.kernel}: {detail}"))

    if any(not 1 <= n <= m for n, m in zip(meta.grid, limits.max_grid)):
        bad(f"grid {meta.grid} outside (1..{limits.max_grid})")
    if any(not 1 <= n <= m for n, m in zip(meta.block, limits.max_block)) \
            or meta.threads > limits.max_threads_per_block:
        bad(f"block {meta.block} outside {limits.max_block} or over "
            f"{limits.max_threads_per_block} threads")
    for name, value in meta.int_args.items():
        if not -INT32_MAX - 1 <= value <= INT32_MAX:
            bad(f"int argument {name} = {value} does not fit in 32 bits")
    for op in meta.operands:
        if math.prod(op.shape) - 1 > 2 ** (op.index_bits - 1) - 1:
            bad(f"{op.name} {op.shape}: element offsets exceed the "
                f"kernel's {op.index_bits}-bit index")
        if op.walk is not None and op.walk != op.shape[-1]:
            bad(f"{op.name}: the grid-stride walk visits {op.walk} of "
                f"{op.shape[-1]} elements a row")
        if op.index_map is None or op.tile is None:
            continue
        for pt in _grid_points(meta.grid, max_points):
            idx = tuple(op.index_map(*pt))
            if len(idx) != len(op.tile) or any(
                    _outside(i * t, (i + 1) * t, dim, t, a in op.ragged)
                    for a, (i, t, dim) in enumerate(zip(idx, op.tile,
                                                        op.shape))):
                bad(f"{op.name}: block {pt} -> tile index {idx} puts tile "
                    f"{op.tile} outside {op.shape}")
                break                      # one point per operand is enough
    for tm in meta.tensor_maps:
        for pt in _grid_points(meta.grid, max_points):
            span = tm.span(*pt)
            if any(_outside(lo, hi, dim, box, True) for (lo, hi), dim, box
                   in zip(span, tm.dims, tm.box)):
                bad(f"{tm.name}: block {pt} -> boxes over {span} outside "
                    f"{tm.dims}")
                break
    if meta.cooperative and meta.blocks > limits.sms * (
            meta.blocks_per_sm or 1):
        bad(f"cooperative grid of {meta.blocks} blocks cannot be resident "
            f"at once on {limits.sms} SMs x {meta.blocks_per_sm or 1}")
    return out


def check_launch(meta: LaunchMeta, site: str,
                 limits: DeviceLimits = HOPPER) -> list[Finding]:
    """All launch rules over one launch."""
    return (check_tiles(meta, site, limits) + check_smem(meta, site, limits)
            + check_grid(meta, site, limits))
