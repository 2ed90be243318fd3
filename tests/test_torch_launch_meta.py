"""The kernels' launch metas (``repro_torch.kernels.launch_meta``) and the
launch rules that read them (``repro_torch.analysis.launch_check``).

Each of GBA-TILE-001, GBA-VMEM-001, GBA-VMEM-002 and GBA-GRID-001 fires on
a meta broken on purpose, as ``tests/test_analysis.py`` trips the
reference's Pallas rules, and stays silent on the meta it was broken from.
Each declared shared-memory formula equals the sum of its regions, as
``tests/test_quantized_wire.py`` holds the reference's VMEM formula.  The
static limits are the wrappers' run-time refusals, on ``meta`` tensors.
``flash_decode``'s meta is built from the plans its wrapper launches with.
Row (f) of the audit at granite-8b's full width (36 layers) needs four PS
shards before a shard's N fits the kernel's int32 argument.  The port's
``kernel_metas()`` covers every kernel and shape of the reference's.
Nothing here builds or launches a kernel: the geometry is static.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import audit as ref_audit
from repro_torch.analysis import audit as AU
from repro_torch.analysis.launch_check import check_launch
from repro_torch.configs import get_config
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import fused_adagrad, gba_aggregate, gba_apply
from repro_torch.kernels import quantize as Q
from repro_torch.kernels.launch_meta import HOPPER, SmemMeta
from repro_torch.launch.train import run_embedding_smoke

BF16 = torch.bfloat16


def rules_of(meta) -> list[str]:
    return sorted({f.rule for f in check_launch(meta, "t")})


@pytest.fixture(scope="module")
def ring():
    """The bfloat16 ring at decode_32k with zamba2's head dim 80."""
    return FD.launch_meta(4, 32_768, 8, 4, 80, BF16)


@pytest.fixture(scope="module")
def metas():
    return AU.kernel_metas()


# ---------------------------------------------------------------------------
# each rule fires on its seeded bad meta, and is silent on the good one
# ---------------------------------------------------------------------------

def test_good_metas_are_silent(ring, metas):
    assert rules_of(ring) == []
    assert AU.audit_kernels().ok
    for meta in metas:
        assert rules_of(meta) == [], meta.site


def test_vmem_001_trips_on_a_formula_16_bytes_off(ring):
    bad = dataclasses.replace(ring,
                              declared_smem_bytes=ring.declared_smem_bytes
                              + 16)
    assert rules_of(bad) == ["GBA-VMEM-001"]


def test_vmem_002_trips_on_240_kb_of_shared_memory():
    good = gba_apply.launch_meta(1 << 20, 4)
    bad = dataclasses.replace(good,
                              dynamic_smem=(SmemMeta("weights", 240 * 1024),),
                              declared_smem_bytes=240 * 1024)
    assert rules_of(good) == [] and rules_of(bad) == ["GBA-VMEM-002"]


def test_vmem_002_counts_the_blocks_an_sm(ring):
    bad = dataclasses.replace(ring, blocks_per_sm=3)
    assert rules_of(bad) == ["GBA-VMEM-002"]


def test_grid_001_trips_on_grid_y_65536():
    meta = FD.launch_meta(4, 64, 65_536, 1, 128, BF16)
    assert meta.grid[1] == 65_536
    assert rules_of(meta) == ["GBA-GRID-001"]
    assert rules_of(FD.launch_meta(4, 64, 65_535, 1, 128, BF16)) == []


def test_tile_001_trips_on_an_80_value_bf16_box_under_the_swizzle(ring):
    maps = tuple(dataclasses.replace(m, box=(80, *m.box[1:]))
                 for m in ring.tensor_maps)
    assert rules_of(dataclasses.replace(ring, tensor_maps=maps)) == [
        "GBA-TILE-001"]


def test_tile_001_trips_on_a_partial_vector_and_a_partial_warp():
    good = gba_apply.launch_meta(4096, 4)
    vec = tuple(dataclasses.replace(op, vec=4, walk=op.shape[-1])
                for op in gba_apply.launch_meta(4099, 4).operands[:3])
    bad = dataclasses.replace(gba_apply.launch_meta(4099, 4), operands=vec)
    assert rules_of(bad) == ["GBA-TILE-001"]
    assert rules_of(dataclasses.replace(good, block=(80, 1, 1))) == [
        "GBA-TILE-001"]


def test_grid_001_trips_on_an_index_map_off_the_end():
    good = Q.quantize_launch_meta(8, 1 << 14, 2048, "minmax")
    n = (1 << 14) // 2048
    ops = tuple(dataclasses.replace(op, index_map=lambda i, *_: (
        i // n, i % n + 1)) if op.name == "payload" else op
        for op in good.operands)
    assert rules_of(dataclasses.replace(good, operands=ops)) == [
        "GBA-GRID-001"]


def test_grid_001_trips_on_a_short_walk_and_a_cooperative_overflow():
    good = fused_adagrad.launch_meta(1 << 16)
    ops = tuple(dataclasses.replace(op, walk=op.shape[-1] - 4)
                for op in good.operands)
    assert rules_of(dataclasses.replace(good, operands=ops)) == [
        "GBA-GRID-001"]
    counts = EB.bwd_launch_meta(1, 53_248, 1_600_048, 0)
    assert counts.cooperative and counts.grid == (HOPPER.sms, 1, 1)
    assert rules_of(dataclasses.replace(counts, grid=(HOPPER.sms + 1, 1,
                                                      1))) == ["GBA-GRID-001"]


def test_tensor_map_boxes_pass_the_row_only_at_the_last_head(ring):
    """The calibration: at hd 80 the last head's second box passes the
    row by 48 values (zeros); a span one box further is a finding."""
    k_map = ring.tensor_maps[0]
    kv = ring.grid[1]
    (lo, hi), _, _ = k_map.span(0, kv - 1, 0)
    assert hi - k_map.dims[0] == 48 and lo < k_map.dims[0]
    assert all(k_map.span(0, y, 0)[0][1] <= k_map.dims[0]
               for y in range(kv - 1))
    far = dataclasses.replace(k_map, span=lambda x, y, z: tuple(
        (a + 64 * (i == 0), b + 64 * (i == 0))
        for i, (a, b) in enumerate(k_map.span(x, y, z))))
    assert rules_of(dataclasses.replace(ring, tensor_maps=(far,))) == [
        "GBA-GRID-001"]


# ---------------------------------------------------------------------------
# declared formulas against the regions
# ---------------------------------------------------------------------------

def test_declared_formulas_equal_their_regions(metas):
    declared = [m for m in metas if m.declared_smem_bytes is not None]
    assert {m.kernel for m in declared} == {
        "gba_aggregate", "embedding_bag_grad_resident", "flash_decode_ring"}
    for meta in declared + [AU.arch_apply_meta(get_config("granite-8b")
                                               .reduced())]:
        assert meta.smem_bytes(meta.smem_counted) == \
            meta.declared_smem_bytes == meta.dynamic_smem_bytes(), meta.site


@pytest.mark.parametrize("hd", FD.HEAD_DIMS)
def test_flash_decode_meta_is_its_plans(hd):
    sms = HOPPER.sms
    smem = (HOPPER.smem_per_block_optin, HOPPER.smem_per_sm,
            HOPPER.smem_reserved_per_block)
    b, length, kv, g = 4, 32_768, 8, 4
    chunk, nsplit, stages, per_sm = FD.ring_plan(length, b * kv, sms, hd,
                                                 smem)
    meta = FD.launch_meta(b, length, kv, g, hd, BF16)
    assert meta.grid == (nsplit, kv, b) and meta.block == (160, 1, 1)
    assert meta.dynamic_smem_bytes() == FD.ring_smem_bytes(hd, stages)
    assert meta.blocks_per_sm == per_sm
    assert meta.int_args["chunk"] == chunk and meta.int_args["stages"] == \
        stages
    assert [m.box for m in meta.tensor_maps] == [(64, FD.TILE, 1)] * 2
    split, combine = FD.launch_meta(b, length, kv, g, hd)
    chunk, nsplit = FD.split_plan(length, b * kv, sms,
                                  FD.STAGE_BYTES // (hd * 4))
    assert split.grid == (nsplit, kv, b)
    assert split.block == (FD.split_threads(hd), 1, 1)
    assert split.int_args["chunk"] == chunk
    assert split.dynamic_smem_bytes() == 4 * FD.STAGE_BYTES
    assert combine.grid == (b * kv * g, 1, 1) and combine.block == (hd, 1, 1)
    assert FD.plan(b, length, kv, hd, BF16, sms, smem)["path"] == "ring"


def test_resident_and_grad_metas_are_their_plans():
    threads, chunk, smem = EB.resident_plan(100_000, 64,
                                            HOPPER.smem_per_block_optin,
                                            HOPPER.sms)
    meta = EB.resident_launch_meta(32, 26, 100_000, 64)
    assert meta.block == (threads, 1, 1) and meta.int_args["chunk"] == chunk
    assert meta.dynamic_smem_bytes() == smem == EB.resident_smem_bytes(64,
                                                                       chunk)
    for d, kernel in ((128, "embedding_bag_grad_segment"),
                      (0, "embedding_bag_grad_counts")):
        design, threads, tile, blocks = EB.grad_plan(100_000, d, HOPPER.sms)
        meta = EB.bwd_launch_meta(32, 26, 100_000, d)
        assert meta.kernel == kernel == f"embedding_bag_grad_{design}"
        assert meta.grid == (blocks, 1, 1) and meta.block == (threads, 1, 1)
        assert meta.int_args["tile_rows"] == tile


def test_grid_stride_metas_follow_alignment():
    """The 4-wide path only where N is a multiple of 4 and the rows are
    aligned, at most 16 blocks an SM, as the sources' host code plans."""
    for fn in (lambda n, **k: gba_apply.launch_meta(n, 4, **k),
               lambda n, **k: gba_aggregate.launch_meta(n, 4, **k),
               lambda n, **k: fused_adagrad.launch_meta(n, **k)):
        wide, odd, off = fn(1 << 20), fn((1 << 20) + 1), fn(1 << 20,
                                                             aligned=False)
        assert wide.operands[0].vec == 4 and wide.grid == (1024, 1, 1)
        assert odd.operands[0].vec == off.operands[0].vec == 1
        assert off.grid == (16 * HOPPER.sms, 1, 1)
        assert rules_of(odd) == rules_of(off) == []


# ---------------------------------------------------------------------------
# the static limits are the wrappers' run-time refusals
# ---------------------------------------------------------------------------

def test_gba_apply_at_2_31_is_refused_statically_and_at_run_time():
    n = 2**31
    assert rules_of(gba_apply.launch_meta(n, 4)) == ["GBA-GRID-001"]
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="int32"):
        gba_apply.gba_apply(torch.empty((n,), device=meta),
                            torch.empty((n,), device=meta),
                            torch.empty((4, n), device=meta),
                            torch.empty((4,), dtype=torch.int32,
                                        device=meta), 9, 1e-3, iota=4)


@pytest.mark.parametrize("b, kv", [(65_536, 1), (1, 65_536)])
def test_flash_decode_grid_limits_are_refused_statically_and_at_run_time(
        b, kv):
    for dtype in (BF16, torch.float32):
        metas = FD.launch_meta(b, 64, kv, 1, 128, dtype)
        metas = metas if isinstance(metas, tuple) else (metas,)
        assert "GBA-GRID-001" in rules_of(metas[0])
    meta = torch.device("meta")
    q = torch.empty((b, kv, 1, 128), dtype=BF16, device=meta)
    k = torch.empty((b, 64, kv, 128), dtype=BF16, device=meta)
    with pytest.raises(ValueError, match="launch grid"):
        FD.flash_decode(q, k, k, 63)
    ok = torch.empty((b - (b > 1), kv - (kv > 1), 1, 128), dtype=BF16,
                     device=meta)
    okk = torch.empty((ok.shape[0], 64, ok.shape[1], 128), dtype=BF16,
                      device=meta)
    assert FD.flash_decode(ok, okk, okk, 63).shape == ok.shape


# ---------------------------------------------------------------------------
# row (f) at full width, and the reference's kernel set
# ---------------------------------------------------------------------------

def test_row_f_at_granite_full_width_needs_four_shards():
    cfg = get_config("granite-8b")
    one, four = AU.arch_apply_meta(cfg, 1), AU.arch_apply_meta(cfg, 4)
    assert one.int_args["n"] > 8.25e9 > 2**31
    assert 2.06e9 < four.int_args["n"] < 2**31
    assert rules_of(one) == ["GBA-GRID-001"] and rules_of(four) == []


_FAMILY = {"fused_adagrad": ("fused_adagrad", "param"),
           "gba_aggregate": ("gba_aggregate", "grads"),
           "embedding_bag_fwd": ("embedding_bag", "out"),
           "embedding_bag_bwd": ("embedding_bag_grad_segment", "gtable"),
           "flash_decode": ("flash_decode_split", "q"),
           "quantize_minmax": ("quantize_minmax", "payload"),
           "quantize_sign": ("quantize_sign", "payload"),
           "dequantize_minmax": ("dequantize_minmax", "out"),
           "dequantize_sign": ("dequantize_sign", "out")}


def _unpadded(ref_shape, block, port_shape) -> bool:
    """The reference pads an operand to whole blocks; the port does not."""
    if len(ref_shape) != len(port_shape):
        return False
    block = block or ref_shape
    return all(r == p or r == -(-p // k) * k
               for r, k, p in zip(ref_shape, block, port_shape))


def test_kernel_metas_cover_the_references(metas):
    for ref in ref_audit.kernel_metas():
        kernel, name = _FAMILY[ref.kernel]
        bm = next(x for x in ref.inputs + ref.outputs if x.name == name)
        assert any(
            m.kernel == kernel and any(
                op.name == name and _unpadded(bm.array_shape, bm.block,
                                              op.shape)
                and np.dtype(bm.dtype).name == str(op.dtype)[6:]
                for op in m.operands) for m in metas), (ref.kernel,
                                                        bm.array_shape)
    kernels = {m.kernel for m in metas}
    assert kernels >= {"embedding_bag_grad_counts",
                       "embedding_bag_grad_resident", "flash_decode_ring",
                       "flash_decode_combine"}
    for hd in FD.HEAD_DIMS:
        for kernel in ("flash_decode_ring", "flash_decode_split"):
            assert any(m.kernel == kernel and m.int_args["hd"] == hd
                       for m in metas), (kernel, hd)
    assert sum("partial" in m.at for m in metas) == 3   # ring, split, combine


def test_vocab_smoke_prints_the_launches_shared_memory():
    lines = []
    run_embedding_smoke(1000, steps=1, device="cpu", log=lines.append)
    fwd = EB.fwd_launch_meta(4, 26, 1000, 16).smem_bytes()
    bwd = EB.bwd_launch_meta(4, 26, 1000, 16).smem_bytes()
    assert (fwd, bwd) == (0, 4244)
    assert f"kernel shared memory fwd={fwd:,}B bwd={bwd:,}B" in lines[0]
