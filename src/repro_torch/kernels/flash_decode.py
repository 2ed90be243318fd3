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
ref.flash_decode_ref``, CUDA tensors launch the kernel or raise, and
``meta`` tensors (the dry run's trace, ``launch.dryrun``) give an output
of the kernel's shape and dtype and do no arithmetic.
``flash_decode.launches`` counts the kernel launches of this process (one
a call: bfloat16 combines the splits in the same launch, float32 in a
second pass that is counted with it).

:func:`flash_decode_partial` is the same kernel under the partial
contract, for one data shard's slice of a KV sequence split over
devices (``models.layers``' sequence-split decode): it also returns each
row's float32 log-sum-exp, writes its output in float32 (unrounded, so
that the slices' outputs combine and round once, as one call's), reads
``pos - start`` as the slice's local position on the card, and gives a
row with no position at or below it ``out = 0`` and ``lse = -inf``; its
launches count in ``flash_decode.launches``.

bfloat16 runs the ring of :func:`ring_plan` (stages of ``TILE`` positions
filled by a producer warp, ``CONSUMER_WARPS`` warps scoring on the tensor
cores); float32 runs the CUDA-core path of :func:`split_plan` with
``STAGE_BYTES`` tiles.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.launch_meta import (HOPPER, INT32_MAX,
                                             DeviceLimits, LaunchMeta,
                                             OperandMeta, SmemMeta,
                                             TensorMapMeta)
from repro_torch.kernels.ref import (flash_decode_partial_ref,
                                     flash_decode_ref)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 112, 128, 256)   # the head dims the kernel takes
MAX_GROUP = 8                # query heads per KV head a block holds
STAGE_BYTES = 16384          # of K (and of V) a float32 block stages per tile
MAX_TILE = 128               # positions a float32 tile holds at most
# float32 split blocks resident on an SM at once: 64 KB of stages each
BLOCKS_PER_SM = 3
# the bfloat16 ring: 4 consumer warps of 16 positions each a stage
CONSUMER_WARPS = 4
TILE = 16 * CONSUMER_WARPS
MIN_STAGES, MAX_STAGES = 3, 4
MAX_SPLITS = 256             # partials the last block of a row weighs


@functools.cache
def _decode():
    lib = runtime.load_library("flash_decode")
    fn = lib.repro_flash_decode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 6 + [
                   ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_flash_decode_smem.argtypes = [ctypes.c_void_p] * 3
    lib.repro_flash_decode_smem.restype = ctypes.c_int
    return fn, lib.repro_flash_decode_smem


@functools.cache
def _device(index: int) -> tuple[int, tuple[int, int, int]]:
    """(SMs, (shared memory a block may use, an SM holds, CUDA keeps
    back a block)) of CUDA device ``index``, read once."""
    smem = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(index):
        runtime.check(_decode()[1](*(ctypes.byref(x) for x in smem)),
                      "reading the shared memory of the device")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            tuple(x.value for x in smem))


@functools.cache
def _tickets(index: int, stream: int, rows: int) -> torch.Tensor:
    """The bfloat16 kernel's per-row tickets for launches on CUDA stream
    ``stream`` of device ``index``: zeros, left at zero by every launch.
    Launches on one stream run one after another, so they share one buffer
    of at most ``rows`` rows; a launch on another stream may run at the
    same time, so it counts on tickets of its own."""
    return torch.zeros((rows,), dtype=torch.int32,
                       device=torch.device("cuda", index))


def _ticket_buffer(index: int, stream: int, rows: int) -> torch.Tensor:
    size = 1 << max(rows - 1, 0).bit_length()   # a few sizes, not one a call
    return _tickets(index, stream, size)


def split_plan(length: int, rows: int, sms: int, tile: int,
               blocks_per_sm: int = BLOCKS_PER_SM,
               max_splits: int | None = None) -> tuple[int, int]:
    """``(chunk, nsplit)``: the cache positions each block walks (a multiple
    of the kernel's ``tile`` of positions) and the blocks per (b, kv) row.
    The ``rows`` (B * KV) rows get as many splits as fit one wave of
    ``blocks_per_sm`` blocks on each of ``sms`` SMs (at least one, at most
    ``max_splits``), so that every resident block walks an equal share."""
    want = max(1, blocks_per_sm * sms // rows)
    if max_splits is not None:
        want = min(want, max_splits)
    chunk = -(-length // want)
    chunk = -(-chunk // tile) * tile
    return chunk, -(-length // chunk)


def ring_stage_bytes(hd: int) -> int:
    """A bfloat16 stage: ``TILE`` rows of K and of V, in ceil(hd / 64)
    boxes of ``TILE`` x 128 bytes each (the tensor map's 128-byte swizzle;
    at hd 80 and 112 the last box's 48 and 16 columns past the head are
    the next head's and are never read)."""
    return 2 * TILE * (-(-hd // 64) * 64) * 2


def ring_smem_bytes(hd: int, stages: int) -> int:
    """The bfloat16 launch's shared memory: 1024 bytes to align the ring,
    the stages and their two barriers each, the consumers' 16 x 8 float32
    p tiles, and a flag.  The kernel's own sum is
    ``repro_flash_decode_ring_smem_bytes``; a card test holds the two
    equal."""
    return 1024 + stages * (ring_stage_bytes(hd) + 16) \
        + CONSUMER_WARPS * 16 * 8 * 4 + 16


def ring_plan(length: int, rows: int, sms: int, hd: int,
              smem: tuple[int, int, int]) -> tuple[int, int, int, int]:
    """``(chunk, nsplit, stages, blocks_per_sm)`` of a bfloat16 launch over
    ``rows`` (B * KV) rows of ``length`` positions, on ``sms`` SMs with
    ``smem`` = (bytes a block may use, bytes an SM holds, bytes kept back
    a block).  Two blocks an SM where each fits ``MIN_STAGES`` stages (hd
    64, 80, 112 and 128), else one (hd 256); as many stages as fit, up to
    ``MAX_STAGES``.  A row whose tiles all fit the ring at once is one
    split: its block asks for every tile in one round trip, and a split
    would add only the combine.  Longer rows take the splits of
    :func:`split_plan` for that many blocks, at most ``MAX_SPLITS``, in
    chunks of whole ``TILE`` s."""
    per_block, per_sm, reserved = smem
    for blocks_per_sm in (2, 1):
        room = min(per_block, per_sm // blocks_per_sm - reserved)
        stages = min(MAX_STAGES, (room - ring_smem_bytes(hd, 0))
                     // (ring_stage_bytes(hd) + 16))
        if stages >= MIN_STAGES:
            break
    else:
        raise ValueError(f"head dim {hd}: {MIN_STAGES} stages do not fit "
                         f"{per_block} bytes of shared memory")
    tiles = -(-length // TILE)
    if tiles <= stages:
        return tiles * TILE, 1, stages, blocks_per_sm
    chunk, nsplit = split_plan(length, rows, sms, TILE, blocks_per_sm,
                               MAX_SPLITS)
    return chunk, nsplit, stages, blocks_per_sm


def plan(b: int, length: int, kv: int, hd: int, dtype: torch.dtype,
         sms: int, smem: tuple[int, int, int]) -> dict:
    """How a call of these shapes and dtype launches on a card of ``sms``
    SMs and ``smem`` (as :func:`ring_plan` takes it): ``path`` ("ring"
    for bfloat16, "cuda cores" for float32), the ``chunk`` of positions a
    block walks, ``nsplit`` blocks a (b, kv) row, the ``stages`` a block
    keeps in flight and ``blocks_per_sm``."""
    if dtype == torch.bfloat16:
        chunk, nsplit, stages, per_sm = ring_plan(length, b * kv, sms, hd,
                                                  smem)
        return {"path": "ring", "chunk": chunk, "nsplit": nsplit,
                "stages": stages, "blocks_per_sm": per_sm}
    chunk, nsplit = split_plan(length, b * kv, sms, STAGE_BYTES // (hd * 4))
    return {"path": "cuda cores", "chunk": chunk, "nsplit": nsplit,
            "stages": 2, "blocks_per_sm": BLOCKS_PER_SM}


def launch_plan(q: torch.Tensor, k: torch.Tensor) -> dict:
    """:func:`plan` of a call on CUDA tensors of these shapes and dtype,
    with the SMs and shared memory of their card."""
    b, kv, _, hd = q.shape
    sms, smem = _device(q.device.index)
    return plan(b, k.shape[1], kv, hd, q.dtype, sms, smem)


def split_threads(hd: int) -> int:
    """Threads of a float32 split block (``csrc/flash_decode.cu``'s
    ``split_threads``): hd rounded up to whole warps, and up again until
    the warps' count divides hd (128 at hd 80 and 112)."""
    t = -(-hd // 32) * 32
    while hd % (t // 32):
        t += 32
    return t


def launch_meta(b: int, l: int, kv: int, g: int, hd: int,
                dtype=torch.float32, partial: bool = False, *,
                limits: DeviceLimits = HOPPER
                ) -> LaunchMeta | tuple[LaunchMeta, LaunchMeta]:
    """The launches one call at q (b, kv, g, hd), k and v (b, l, kv, hd)
    makes, planned by :func:`plan` with ``limits``' SMs and shared memory:
    bfloat16 one ring launch (grid (nsplit, kv, b), a producer and
    ``CONSUMER_WARPS`` consumer warps, the :func:`ring_smem_bytes` regions,
    K and V through two tensor maps of (64, ``TILE``, 1) boxes under the
    128-byte swizzle); float32 the split launch (two stages of K and of V
    in dynamic shared memory, the p tile and the softmax state in static)
    and the combine launch (one block of hd threads a (b, kv, g) row);
    the split copies K and V in 16-byte pieces (``cp.async``).
    ``partial`` writes float32 out and the log-sum-exp."""
    smem = (limits.smem_per_block_optin, limits.smem_per_sm,
            limits.smem_reserved_per_block)
    p = plan(b, l, kv, hd, dtype, limits.sms, smem)
    chunk, nsplit = p["chunk"], p["nsplit"]
    at = f"({b}, {l}, {kv}, {g}, {hd}) {str(dtype)[6:]}" + (
        " partial" if partial else "")
    out_dtype = torch.float32 if partial else dtype

    def row(*tail):
        return lambda x, y, z: (z, y, *tail)

    q = OperandMeta("q", (b, kv, g, hd), dtype, (1, 1, g, hd), row(0, 0))
    out = OperandMeta("out", (b, kv, g, hd), out_dtype, (1, 1, g, hd),
                      row(0, 0))
    parts = (
        OperandMeta("part_m", (b, kv, nsplit, g), torch.float32,
                    (1, 1, 1, g), lambda x, y, z: (z, y, x, 0)),
        OperandMeta("part_l", (b, kv, nsplit, g), torch.float32,
                    (1, 1, 1, g), lambda x, y, z: (z, y, x, 0)),
        OperandMeta("part_acc", (b, kv, nsplit, g, hd), torch.float32,
                    (1, 1, 1, g, hd), lambda x, y, z: (z, y, x, 0, 0)))
    lse = (OperandMeta("lse", (b, kv, g), torch.float32, (1, 1, g),
                       row(0)),) if partial else ()
    args = {"b": b, "length": l, "kv_heads": kv, "g_heads": g, "hd": hd,
            "chunk": chunk, "nsplit": nsplit}
    if p["path"] == "ring":
        stages = p["stages"]
        boxes = -(-hd // 64)
        row_elems = kv * hd

        def span(x, y, z):
            start = x * chunk
            tiles = -(-(min(start + chunk, l) - start) // TILE)
            return ((y * hd, y * hd + boxes * 64),
                    (start, start + tiles * TILE), (z, z + 1))

        maps = tuple(TensorMapMeta(
            name, (row_elems, l, b), (row_elems * 2, row_elems * 2 * l),
            (64, TILE, 1), 2, 128, span) for name in ("k_map", "v_map"))
        regions = (SmemMeta("align", 1024),
                   SmemMeta("stages", stages * ring_stage_bytes(hd)),
                   SmemMeta("barriers", stages * 16),
                   SmemMeta("p_tiles", CONSUMER_WARPS * 16 * 8 * 4),
                   SmemMeta("flag", 16))
        return LaunchMeta(
            "flash_decode_ring", at, (nsplit, kv, b),
            ((CONSUMER_WARPS + 1) * 32, 1, 1),
            (q, *parts, OperandMeta("tickets", (b * kv,), torch.int32,
                                    (1,), lambda x, y, z: (z * kv + y,)),
             out, *lse),
            dynamic_smem=regions,
            declared_smem_bytes=ring_smem_bytes(hd, stages),
            smem_counted=tuple(r.name for r in regions), tensor_maps=maps,
            int_args={**args, "stages": stages},
            blocks_per_sm=p["blocks_per_sm"])
    threads = split_threads(hd)
    cache = tuple(OperandMeta(name, (b, l, kv, hd), dtype, (1, chunk, 1, hd),
                              lambda x, y, z: (z, x, y, 0), ragged=(1,),
                              vec=16 // 4)
                  for name in ("k", "v"))
    split = LaunchMeta(
        "flash_decode_split", at, (nsplit, kv, b), (threads, 1, 1),
        (q, *cache, *parts),
        dynamic_smem=(SmemMeta("k_stages", 2 * STAGE_BYTES),
                      SmemMeta("v_stages", 2 * STAGE_BYTES)),
        static_smem=(SmemMeta("s_p", MAX_GROUP * MAX_TILE * 4),
                     SmemMeta("softmax", 3 * MAX_GROUP * 4)),
        int_args=args, blocks_per_sm=BLOCKS_PER_SM)
    rows = b * kv * g

    def flat(*tail):
        return lambda r, *_: (r // (kv * g), r // g % kv, 0, r % g, *tail)

    combine = LaunchMeta(
        "flash_decode_combine", at, (rows, 1, 1), (hd, 1, 1), (
            OperandMeta("part_acc", (b, kv, nsplit, g, hd), torch.float32,
                        (1, 1, nsplit, 1, hd), flat(0)),
            OperandMeta("out", (rows, hd), out_dtype, (1, hd),
                        lambda r, *_: (r, 0)),
            *(OperandMeta("lse", (rows,), torch.float32, (1,),
                          lambda r, *_: (r,)) for _ in lse)),
        int_args={"rows": rows, "g_heads": g, "nsplit": nsplit})
    return split, combine


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
    # the grid is (splits, KV, B), and float32 combines B * KV * G rows
    _, max_y, max_z = HOPPER.max_grid
    if kv > max_y or b > max_z or b * kv * g > INT32_MAX:
        raise ValueError(f"B = {b}, KV = {kv}, G = {g}: the launch grid "
                         f"takes B <= {max_z}, KV <= {max_y} and B * KV * G "
                         f"<= {INT32_MAX}")


def _pos(pos: int | torch.Tensor) -> int | torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype.is_floating_point or \
                pos.dtype == torch.bool:
            raise TypeError(f"pos must be a 0-d integer tensor, got "
                            f"{pos.dtype} of shape {tuple(pos.shape)}")
        return pos
    return operator.index(pos)


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         pos: int | torch.Tensor, start: int, partial: bool):
    """One call on one device: ``(out, lse)``, ``lse`` None unless
    ``partial``."""
    _check(q, k, v)
    pos = _pos(pos)
    start = operator.index(start)
    if not -2**31 <= start < 2**31:
        raise ValueError(f"start {start} is not an int32")
    on = {t.device for t in (q, k, v)}
    if isinstance(pos, torch.Tensor):
        on.add(pos.device)
    b, kv, g, hd = q.shape
    if on == {torch.device("cpu")}:
        with runtime.plain_region("flash_decode"):
            if partial:
                return flash_decode_partial_ref(q, k, v, pos, start)
            return flash_decode_ref(q, k, v, pos), None
    if {d.type for d in on} == {"meta"}:
        # shapes alone (the dry run's trace): the kernel's outputs, no
        # arithmetic, as a registered fake kernel would give them
        if not partial:
            return torch.empty_like(q), None
        return (torch.empty_like(q, dtype=torch.float32),
                torch.empty((b, kv, g), dtype=torch.float32,
                            device=q.device))
    if len(on) != 1 or q.device.type != "cuda":
        raise ValueError(f"q, k, v and a pos tensor must all lie on the CPU "
                         f"or on one CUDA device, got {sorted(map(str, on))}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    length = k.shape[1]
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary (the "
                         "kernel copies them in 16-byte pieces)")
    dev = q.device
    pos_t = (pos.to(torch.int32) if isinstance(pos, torch.Tensor) else
             torch.full((), pos, dtype=torch.int32, device=dev))
    plan = launch_plan(q, k)
    chunk, nsplit, stages = plan["chunk"], plan["nsplit"], plan["stages"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = (_ticket_buffer(dev.index, stream, b * kv)
               if plan["path"] == "ring" else None)
    part_m = torch.empty((b, kv, nsplit, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, nsplit, g, hd), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q, dtype=torch.float32 if partial else q.dtype)
    lse = (torch.empty((b, kv, g), dtype=torch.float32, device=dev)
           if partial else None)
    with torch.cuda.device(dev):
        err = _decode()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           _DTYPE_CODE[q.dtype], pos_t.data_ptr(), start,
                           part_m.data_ptr(), part_l.data_ptr(),
                           part_acc.data_ptr(),
                           None if tickets is None else tickets.data_ptr(),
                           out.data_ptr(),
                           None if lse is None else lse.data_ptr(), b,
                           length, kv, g, hd, chunk, nsplit, stages, stream)
    runtime.check(err, "flash_decode kernel launch")
    flash_decode.launches += 1
    return out, lse


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int | torch.Tensor) -> torch.Tensor:
    """q (B, KV, G, hd), k and v (B, L, KV, hd), one dtype (float32 or
    bfloat16); ``pos`` the last valid cache index, an int or a 0-d integer
    tensor on q's device -> (B, KV, G, hd) in q's dtype, a new tensor.
    Every position ``idx > pos`` is masked; the arithmetic is
    :func:`flash_decode_ref`'s, summed in another order.

    The kernel takes hd in ``HEAD_DIMS`` (64, 80, 112, 128, 256), G from
    1 to ``MAX_GROUP`` (8), any L from 1 to 2**31 - 1 (a partial last tile
    is masked), and contiguous tensors, k and v on 16-byte boundaries; the
    wrapper refuses anything else on either device (the boundary on the
    card only).  A ``pos`` tensor stays on the card: the kernel reads it
    there, so a decode loop needs no host round trip."""
    return _run(q, k, v, pos, 0, False)[0]


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int | torch.Tensor, start: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_decode` of q over one slice k, v (B, L, KV, hd) of a
    longer sequence whose first position is ``start``: ``pos`` is the last
    valid index of the whole sequence, and the kernel reads ``pos -
    start`` on the card (no host round trip, no branch on its sign).
    Returns ``(out, lse)``, both float32: out (B, KV, G, hd), the row's
    ``acc / l`` unrounded (a bfloat16 call too), and lse (B, KV, G), each
    row's ``m + log(l)`` over its positions ``idx <= pos - start`` in the
    scale of the scores (``(q . k) / sqrt(hd)``).  A row with no such
    position gives ``out = 0`` and ``lse = -inf``, so that the slices'
    partials combine as ``sum_s exp(lse_s - M) out_s / sum_s exp(lse_s -
    M)`` and round once to q's dtype, as :func:`flash_decode`'s output
    does.  The same checks, dispatch and launch count as
    :func:`flash_decode`."""
    return _run(q, k, v, pos, start, True)


flash_decode.launches = 0
