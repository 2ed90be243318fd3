"""The port's ``flash_decode`` plain version against the Pallas kernel.

``repro_torch.kernels.ref.flash_decode_ref`` is held against
``repro.kernels.flash_decode.flash_decode`` run in interpret mode, at the
four shapes of ``tests/test_kernels.py::test_flash_decode``, on the same
numpy inputs (bfloat16 inputs are the float32 draws rounded to bfloat16
alike on both sides).  Tolerances, with their reasons:

* float32: within 1e-6 of the largest output magnitude.  The plain
  version follows the Pallas kernel block by block; XLA evaluates the
  einsums and the division by sqrt(hd) in orders of its own (it may
  multiply by the reciprocal inside the compiled kernel), so the two
  agree to float32 rounding, not bit for bit.
* bfloat16: within one bfloat16 ulp (rtol 2**-7, atol 1e-6): both sides
  compute in float32 and round the output once, so an output whose
  float32 value lies at a rounding boundary may round the other way.

The partial last block (an L that is not a multiple of 512, which the
Pallas kernel refuses) and the edge positions 0 and L - 1 are held to a
one-pass softmax in float64 within 1e-6 of the largest magnitude.  The
wrapper is held to its contract: the plain version on CPU tensors, and
the dtypes, shapes and devices it refuses.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (CONSUMER_WARPS, HEAD_DIMS,
                                              MAX_GROUP, MAX_SPLITS,
                                              MAX_STAGES, MIN_STAGES, TILE,
                                              flash_decode, ring_plan,
                                              ring_smem_bytes,
                                              ring_stage_bytes, split_plan)
from repro_torch.kernels.ref import flash_decode_ref

PALLAS_CASES = [(2, 2, 4, 64, 1024, 1000), (1, 4, 1, 32, 512, 511),
                (3, 1, 8, 16, 1024, 37), (1, 8, 2, 128, 512, 200),
                (2, 2, 8, 112, 1024, 700),   # kimi-k2: hd 112, G 8
                (2, 4, 1, 80, 1024, 900)]    # zamba2: hd 80, G 1
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6


def _inputs(b, kv, g, hd, length, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, hd), np.float32)
    k = rng.standard_normal((b, length, kv, hd), np.float32)
    v = rng.standard_normal((b, length, kv, hd), np.float32)
    return q, k, v


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _close_to_max(got, want, frac):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def _one_pass(q, k, v, pos):
    """softmax over positions <= pos, then the weighted sum of v, in
    float64: (B, KV, G, hd)."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum("bngh,blnh->bngl", q, k) / math.sqrt(q.shape[-1])
    s = np.where(np.arange(k.shape[1]) <= pos, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bngl,blnh->bngh", p, v)


@pytest.mark.parametrize("b,kv,g,hd,length,pos", PALLAS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(b, kv, g, hd, length, pos,
                                             dtype):
    q, k, v = _inputs(b, kv, g, hd, length, seed=b * 100 + kv)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(pallas_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), pos),
        np.float32)
    got = flash_decode_ref(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                           pos)
    assert got.dtype == tdt and got.shape == (b, kv, g, hd)
    got = got.float().numpy()
    if dtype == "float32":
        _close_to_max(got, want, 1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("length", [160, 544, 1100])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_partial_last_block_and_edge_positions(length, where):
    q, k, v = _inputs(2, 8, 4, 128, length, seed=length)
    pos = {"first": 0, "mid": length // 2 + 3, "last": length - 1}[where]
    got = flash_decode_ref(*(_torch(x, torch.float32) for x in (q, k, v)),
                           torch.tensor(pos, dtype=torch.int32))
    _close_to_max(got.numpy(), _one_pass(q, k, v, pos), 1e-6)


def test_pos_zero_is_the_first_value_row():
    """At pos = 0 one position is valid: the output is v[:, 0] exactly."""
    q, k, v = _inputs(2, 2, 4, 64, 544)
    got = flash_decode_ref(*(_torch(x, torch.float32) for x in (q, k, v)), 0)
    want = np.broadcast_to(v[:, 0][:, :, None, :], got.shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos", [0, 300, 543, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_the_plain_version_on_the_cpu(pos, dtype):
    q, k, v = (_torch(x, dtype) for x in _inputs(4, 8, 4, 128, 544))
    before = ops.kernel_calls["flash_decode"]
    launches = flash_decode.launches
    got = ops.flash_decode(q, k, v, torch.tensor(pos, dtype=torch.int32))
    assert torch.equal(got, flash_decode_ref(q, k, v, pos))
    assert torch.equal(flash_decode(q, k, v, pos), got)
    assert ops.kernel_calls["flash_decode"] == before + 1
    assert flash_decode.launches == launches          # no kernel on the CPU


def _bad_calls():
    q, k, v = (_torch(x, torch.float32) for x in _inputs(2, 2, 4, 64, 64))
    bf = torch.bfloat16
    return {
        "mixed dtypes": ((q, k.to(bf), v), TypeError),
        "float16": ((q.half(), k.half(), v.half()), TypeError),
        "k, v shapes differ": ((q, k, v[:, :32]), ValueError),
        "batch differs": ((q[:1], k, v), ValueError),
        "kv heads differ": ((q[:, :1], k, v), ValueError),
        "head dim differs": ((q[..., :32], k, v), ValueError),
        "3-d q": ((q[0], k, v), ValueError),
        "empty cache": ((q, k[:, :0], v[:, :0]), ValueError),
        "head dim 32": ((q[..., :32], k[..., :32].contiguous(),
                         v[..., :32].contiguous()), ValueError),
        "group of 16": ((q.repeat(1, 1, 4, 1), k, v), ValueError),
        # all-meta tensors take the meta branch (the dry run's trace,
        # tests/test_torch_dryrun.py); meta beside CPU is refused
        "meta device": ((q.to("meta"), k.to("meta"), v), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_refuses(case):
    (q, k, v), err = _bad_calls()[case]
    with pytest.raises(err):
        flash_decode(q, k, v, 3)


@pytest.mark.parametrize("pos", [torch.tensor([3]), torch.tensor(3.0),
                                 torch.tensor(True), 3.0])
def test_wrapper_refuses_a_pos_that_is_not_one_integer(pos):
    q, k, v = (_torch(x, torch.float32) for x in _inputs(1, 2, 4, 64, 32))
    with pytest.raises(TypeError):
        flash_decode(q, k, v, pos)


def test_supported_set():
    assert HEAD_DIMS == (64, 80, 112, 128, 256) and MAX_GROUP == 8


@pytest.mark.parametrize("length,rows,sms,tile,want", [
    (32_768, 32, 132, 64, (2752, 12)),   # decode_32k: 384 blocks, one wave
    (160, 32, 132, 64, (64, 3)),         # the serve loop's cache
    (544, 4, 132, 64, (64, 9)),
    (1, 1, 132, 128, (128, 1)),
    (100_000, 1, 1, 16, (33_344, 3)),
    (4096, 500, 132, 32, (4096, 1)),     # more rows than a wave: no split
])
def test_split_plan_covers_the_cache_in_tiles(length, rows, sms, tile, want):
    chunk, nsplit = split_plan(length, rows, sms, tile)
    assert (chunk, nsplit) == want
    assert chunk % tile == 0
    assert chunk * nsplit >= length > chunk * (nsplit - 1)


# an H100's shared memory: a block may use, an SM holds, kept back a block
H100_SMEM = (232_448, 233_472, 1_024)


@pytest.mark.parametrize("length,rows,hd,want", [
    (32_768, 32, 128, (4096, 8, 3, 2)),   # decode_32k: 256 blocks, one wave
    (160, 32, 128, (192, 1, 3, 2)),       # the serve loop: one round trip
    (25, 4, 64, (64, 1, 4, 2)),           # granite-8b.reduced()
    (544, 32, 128, (128, 5, 3, 2)),
    (700, 2, 256, (64, 11, 3, 1)),
    (1 << 20, 1, 128, (4096, 256, 3, 2)),  # one row: MAX_SPLITS splits
    (160, 32, 112, (192, 1, 3, 2)),       # kimi-k2's serve loop, as hd 128
    (32_768, 32, 112, (4096, 8, 3, 2)),
    (160, 128, 80, (192, 1, 3, 2)),       # zamba2's serve loop, as hd 128
    (32_768, 128, 80, (16384, 2, 3, 2)),  # zamba2's 4 x 32 rows: 2 splits
    (32_768, 32, 80, (4096, 8, 3, 2)),
])
def test_ring_plan_at_the_paths_shapes(length, rows, hd, want):
    assert ring_plan(length, rows, 132, hd, H100_SMEM) == want


def _positions_read(length, pos, chunk, nsplit):
    """The positions the bfloat16 kernel reads, split by split, tile by
    tile, consumer warp by warp, as its index arithmetic walks them."""
    seen = []
    for split in range(nsplit):
        start = split * chunk
        end = min(start + chunk, length)
        last = pos + 1 if 0 <= pos < end else end
        ntiles = -(-(last - start) // TILE) if last > start else 0
        for j in range(ntiles):
            for w in range(CONSUMER_WARPS):
                t0 = start + j * TILE + w * 16
                seen += range(t0, t0 + max(0, min(16, last - t0)))
    return seen


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("rows", [1, 3, 32, 64, 500])
@pytest.mark.parametrize("length", [1, 40, 64, 65, 160, 1000, 4097])
def test_ring_plan_reads_every_position_once_and_fits(length, rows, hd):
    chunk, nsplit, stages, per_sm = ring_plan(length, rows, 132, hd,
                                              H100_SMEM)
    assert chunk % TILE == 0 and 1 <= nsplit <= MAX_SPLITS
    assert chunk * nsplit >= length > chunk * (nsplit - 1)
    assert MIN_STAGES <= stages <= MAX_STAGES and per_sm in (1, 2)
    per_block, per_sm_bytes, reserved = H100_SMEM
    smem = ring_smem_bytes(hd, stages)
    assert smem <= per_block and per_sm * (smem + reserved) <= per_sm_bytes
    # the end of the launch reuses the ring: the warps' states (over hd
    # padded to whole 64-value boxes), then the weights of MAX_SPLITS
    # partials
    ring = stages * ring_stage_bytes(hd)
    cols = -(-hd // 64) * 64
    assert CONSUMER_WARPS * (16 + MAX_GROUP * cols) * 4 <= ring
    assert (MAX_SPLITS + 1) * 8 * 4 <= ring
    for pos in {-1, 0, length // 2, length - 1, length + 5}:
        seen = _positions_read(length, pos, chunk, nsplit)
        want = range(min(pos, length - 1) + 1) if pos >= 0 else range(length)
        assert sorted(seen) == list(want) and len(set(seen)) == len(seen)


def test_ring_swizzle_spreads_each_read_over_the_banks():
    """A stage's boxes are 64 rows of 128 bytes under the 128-byte swizzle
    (piece c of row r at piece c ^ (r % 8)), each on a 1024-byte boundary.
    The 8 rows an ldmatrix reads, one piece each, land on 8 distinct
    pieces, and a warp's p . v read of one row of v (a 32nd of the row's
    columns a lane, hd padded to whole boxes: 4 at hd 80 and 112, whose
    last 48 and 16 columns the kernel loads and never reads) touches
    every piece of each box row once."""
    for hd in HEAD_DIMS:
        assert ring_stage_bytes(hd) % 1024 == 0
        for c in range(8):
            assert len({c ^ r for r in range(8)}) == 8
        vpl = -(-hd // 64) * 64 // 32
        for i in range(16):
            pieces = {}
            for lane in range(32):
                e = lane * vpl
                assert e // 8 == (e + vpl - 1) // 8      # one 16-byte piece
                pieces.setdefault(e // 64, set()).add(((e % 64) // 8) ^ (i % 8))
            assert all(p == set(range(8)) for p in pieces.values())
