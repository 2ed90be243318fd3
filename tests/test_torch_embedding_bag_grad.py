"""The port's embedding_bag_grad, pooled lookup gradient and presence counts
on the CPU against the JAX package.

The same ids and gradient rows, made with numpy from a seed, go through
the JAX package's Pallas ``embedding_bag_grad`` in interpret mode (and its
plain ``embedding_bag_grad_ref``) and through the port's wrapper on CPU
tensors, which takes its plain PyTorch version.

The resident backward (the JAX package's first, kept as the oracle of the
streamed one) is held the same way at the shapes of the JAX package's own
oracle test; on the CPU its wrapper takes the same plain version.

Tolerances: counts are exact.  Table gradients are held to rtol=1e-6 /
atol=1e-7 against the Pallas kernels, whose one-hot matmul sums each row
in another order than an entry-order scatter.  The port's plain version sums
each row in entry order from 0.0, which is the CUDA kernel's order, so it
is held bit for bit to a sequential emulation of that kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings import EmbeddingTable as JaxTable
from repro.embeddings import pooled_lookup as jax_pooled_lookup
from repro.embeddings import presence_counts as jax_presence_counts
from repro.kernels.embedding_bag import (
    embedding_bag_grad as jax_embedding_bag_grad)
from repro.kernels.embedding_bag import (
    embedding_bag_grad_resident as jax_embedding_bag_grad_resident)
from repro.kernels.ref import embedding_bag_grad_ref as jax_grad_ref
from repro_torch.convert import params_from_jax
from repro_torch.embeddings import (EmbeddingTable, pooled_lookup,
                                    presence_counts)
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (COUNTS_MAX_IDS,
                                               COUNTS_THREADS,
                                               RESIDENT_BLOCK_V,
                                               RESIDENT_FEW_THREADS,
                                               RESIDENT_MAX_THREADS,
                                               RESIDENT_MIN_CHUNK,
                                               embedding_bag_grad,
                                               embedding_bag_grad_counts,
                                               embedding_bag_grad_resident,
                                               grad_plan,
                                               resident_max_d_for,
                                               resident_plan,
                                               resident_smem_bytes, sort_ids)
from repro_torch.kernels.ref import embedding_bag_grad_ref

GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-7

# (B, F, V, D, id range): "in" draws from [0, V); "odd" mixes in negative
# ids, ids >= V and the sentinel V; "dup" repeats ids inside each bag
CASES = {
    "presence-d1": (1, 300, 700, 1, "odd"),
    "smoke-4x26-d16": (4, 26, 1000, 16, "odd"),
    "dup-d16": (16, 8, 50, 16, "dup"),
    "scalar-d13": (8, 5, 300, 13, "odd"),
    "wide-d200": (4, 8, 600, 200, "in"),
    "in-range-d16": (32, 26, 2048, 16, "in"),
}


def _inputs(b, f, v, d, kind, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, f)).astype(np.int32)
    if kind == "odd":
        mask = rng.random((b, f))
        ids[mask < 0.2] = -1
        ids[(mask >= 0.2) & (mask < 0.3)] = v            # sentinel
        ids[(mask >= 0.3) & (mask < 0.4)] = v + 7
    elif kind == "dup":
        ids[:, f // 2:] = ids[:, :f - f // 2]
        ids[0] = ids[0, 0]
    grad = rng.standard_normal((b, d)).astype(np.float32)
    return ids, grad


def _port(ids, grad, v):
    gt, cnt = embedding_bag_grad(torch.from_numpy(ids),
                                 torch.from_numpy(grad), v)
    return gt.numpy(), cnt.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_kernel_in_interpret_mode(case):
    b, f, v, d, kind = CASES[case]
    ids, grad = _inputs(b, f, v, d, kind)
    want_gt, want_cnt = jax_embedding_bag_grad(
        jnp.asarray(ids), jnp.asarray(grad), v, interpret=True)
    got_gt, got_cnt = _port(ids, grad, v)
    assert got_gt.shape == (v, d) and got_cnt.shape == (v,)
    np.testing.assert_array_equal(got_cnt, np.asarray(want_cnt))
    np.testing.assert_allclose(got_gt, np.asarray(want_gt), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("case", ["presence-d1", "dup-d16", "in-range-d16"])
def test_plain_version_matches_jax_plain_version_on_in_range_ids(case):
    b, f, v, d, _ = CASES[case]
    kind = "dup" if case == "dup-d16" else "in"
    ids, grad = _inputs(b, f, v, d, kind, seed=1)
    want_gt, want_cnt = jax_grad_ref(jnp.asarray(ids), jnp.asarray(grad), v)
    got_gt, got_cnt = _port(ids, grad, v)
    np.testing.assert_array_equal(got_cnt, np.asarray(want_cnt))
    np.testing.assert_allclose(got_gt, np.asarray(want_gt), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def _kernel_emulation(ids, grad, v):
    """What the CUDA kernel computes, one row at a time: the entries of row
    ``r`` in stable sorted order, summed in float32 from 0.0."""
    f = ids.shape[1]
    sorted_ids, perm = (t.numpy() for t in sort_ids(torch.from_numpy(ids), v))
    gt = np.zeros((v, grad.shape[1]), np.float32)
    cnt = np.zeros((v,), np.float32)
    for r in range(v):
        run = np.nonzero(sorted_ids == r)[0]
        acc = np.zeros(grad.shape[1], np.float32)
        for e in run:
            acc = (acc + grad[perm[e] // f]).astype(np.float32)
        gt[r], cnt[r] = acc, run.size
    return gt, cnt


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_sums_each_row_in_entry_order_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, 43, size=(64, 26)).astype(np.int32)
    # magnitudes spread over 12 decades, so the order of the adds shows
    grad = (rng.standard_normal((64, 16))
            * 10.0 ** rng.integers(-6, 6, size=(64, 1))).astype(np.float32)
    want_gt, want_cnt = _kernel_emulation(ids, grad, 40)
    got_gt, got_cnt = _port(ids, grad, 40)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_gt.view(np.uint32),
                                  want_gt.view(np.uint32))
    reversed_gt = _kernel_emulation(ids[::-1].copy(), grad[::-1].copy(), 40)[0]
    assert not np.array_equal(reversed_gt, want_gt)   # the order matters


def test_out_of_range_ids_add_nothing():
    ids = torch.tensor([[0, -1, 4, 3], [-4, 5, 4, 0]], dtype=torch.int32)
    grad = torch.tensor([[1.0, 2.0], [10.0, 20.0]])
    gt, cnt = embedding_bag_grad(ids, grad, 4)
    torch.testing.assert_close(gt, torch.tensor(
        [[11.0, 22.0], [0.0, 0.0], [0.0, 0.0], [1.0, 2.0]]))
    torch.testing.assert_close(cnt, torch.tensor([2.0, 0.0, 0.0, 1.0]))


@pytest.mark.parametrize("shape", [(0, 26, 16), (3, 0, 16), (3, 4, 0)])
def test_empty_batch_and_zero_width(shape):
    b, f, d = shape
    ids = torch.zeros((b, f), dtype=torch.int32)
    gt, cnt = embedding_bag_grad(ids, torch.ones((b, d)), 10)
    assert gt.shape == (10, d) and cnt.shape == (10,)
    assert not gt.any()
    assert cnt.sum() == b * f


@pytest.mark.parametrize("d", [0, 1, 16])
def test_counts_do_not_depend_on_the_gradient_width(d):
    """``presence_counts`` asks for the counts alone with width-0 gradient
    rows; they equal the counts that come with rows of any width."""
    ids, grad = _inputs(8, 26, 300, d, "odd", seed=5)
    _, want = embedding_bag_grad_ref(torch.from_numpy(ids),
                                     torch.zeros((8, 1)), 300)
    gt, got = _port(ids, grad, 300)
    assert gt.shape == (300, d)
    np.testing.assert_array_equal(got, want.numpy())


def test_sort_ids_maps_out_of_range_to_the_sentinel_stably():
    ids = torch.tensor([[3, -1, 1], [3, 7, 1]], dtype=torch.int32)
    sorted_ids, perm = sort_ids(ids, 5)
    assert sorted_ids.dtype == torch.int32 and perm.dtype == torch.int64
    assert sorted_ids.tolist() == [1, 1, 3, 3, 5, 5]
    assert perm.tolist() == [2, 5, 0, 3, 1, 4]


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    ids, grad = _inputs(4, 8, 100, 8, "odd")
    ids_t, grad_t = torch.from_numpy(ids), torch.from_numpy(grad)
    launches = embedding_bag_grad.launches
    calls = ops.kernel_calls["pooled_lookup_grad"]
    gt, cnt = ops.pooled_lookup_grad(ids_t, grad_t, 100)
    want_gt, want_cnt = embedding_bag_grad_ref(ids_t, grad_t, 100)
    assert torch.equal(gt, want_gt) and torch.equal(cnt, want_cnt)
    assert embedding_bag_grad.launches == launches          # no CUDA launch
    assert ops.kernel_calls["pooled_lookup_grad"] == calls + 1


@pytest.mark.parametrize("bad", ["ids-int64", "grad-f64", "grad-bf16",
                                 "ids-1d", "batch-mismatch", "capacity",
                                 "meta-device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ids = torch.zeros((2, 3), dtype=torch.int32)
    grad = torch.zeros((2, 4), dtype=torch.float32)
    capacity, err = 5, ValueError
    if bad == "ids-int64":
        ids, err = ids.long(), TypeError
    elif bad == "grad-f64":
        grad, err = grad.double(), TypeError
    elif bad == "grad-bf16":
        grad, err = grad.bfloat16(), TypeError
    elif bad == "ids-1d":
        ids = ids.reshape(-1)
    elif bad == "batch-mismatch":
        grad = torch.zeros((3, 4))
    elif bad == "capacity":            # the sentinel must fit in int32
        capacity = 2**31
    else:                              # neither CPU nor CUDA: no fallback
        ids, grad = ids.to("meta"), grad.to("meta")
    with pytest.raises(err):
        embedding_bag_grad(ids, grad, capacity)


@pytest.mark.parametrize("bad", ["ids-int64", "strided", "capacity", "cpu",
                                 "too-many-ids"])
def test_counts_launch_rejects_what_the_kernel_does_not_take(bad):
    """The sort-free counts launch takes contiguous int32 ids on a CUDA
    device, at most 2**24 of them (its float32 sums stay exact); it has no
    plain path to fall back to."""
    ids, capacity, err = torch.zeros((2, 6), dtype=torch.int32), 5, ValueError
    if bad == "ids-int64":
        ids, err = ids.long(), TypeError
    elif bad == "strided":
        ids = ids[:, ::2]
    elif bad == "capacity":
        capacity = 2**31
    elif bad == "too-many-ids":
        assert COUNTS_MAX_IDS == 2**24
        ids = torch.empty((1, COUNTS_MAX_IDS + 1), dtype=torch.int32)
    with pytest.raises(err):
        embedding_bag_grad_counts(ids, capacity)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_lookup_gradient_matches_jax_custom_vjp(dtype):
    rng = np.random.default_rng(3)
    v, d, b, f = 500, 16, 8, 26
    table = (rng.standard_normal((v, d)) * 0.01).astype(np.float32)
    ids = rng.integers(0, v, size=(b, f)).astype(np.int32)
    ids[:, 13:] = ids[:, :13]                        # repeats inside a bag
    w = rng.standard_normal((b, d)).astype(np.float32)
    jtable = jnp.asarray(table).astype(dtype)
    last = jnp.zeros((v,), jnp.int32)

    def jloss(t):
        pooled = jax_pooled_lookup(JaxTable(t, last), jnp.asarray(ids))
        return jnp.sum(pooled.astype(jnp.float32) * w)

    jval, jgrad = jax.value_and_grad(jloss)(jtable)
    t = params_from_jax(np.asarray(jtable), device="cpu").requires_grad_()
    pooled = pooled_lookup(EmbeddingTable(t, torch.zeros(v, dtype=torch.int32)),
                           torch.from_numpy(ids))
    loss = (pooled.float() * torch.from_numpy(w)).sum()
    (tgrad,) = torch.autograd.grad(loss, t)
    assert tgrad.dtype == t.dtype and pooled.dtype == t.dtype
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-6)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:         # both sum in f32 and round once to bf16: one bf16 ulp
        np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
        np.testing.assert_allclose(tgrad.float().numpy(),
                                   np.asarray(jgrad.astype(jnp.float32)),
                                   rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("kind", ["in", "odd", "wild", "repeated", "zipf"])
def test_presence_counts_match_jax_exactly(kind):
    """The trainer's presence counts against the JAX package's (its Pallas
    kernel in interpret mode) and the plain version: in-range ids; slot
    ids of -2 and capacity; negative, sentinel and INT_MAX ids after the
    slot offsets, which count nothing; one id repeated over a whole slot;
    Zipf(1.2)-skewed ids, which put hundreds of entries on a few rows."""
    rng = np.random.default_rng(4)
    m, cap = 4, 300
    ids = rng.integers(0, cap, size=(m, 32, 26)).astype(np.int32)
    if kind == "odd":
        ids[:, :, 0] = -2
        ids[:, :, 1] = cap
    elif kind == "repeated":
        ids[1] = 17
    elif kind == "zipf":
        ids = np.minimum(rng.zipf(1.2, size=(m, 32, 26)) - 1,
                         cap - 1).astype(np.int32)
    flat = ids.reshape(m, -1) + (np.arange(m, dtype=np.int32) * cap)[:, None]
    if kind == "wild":
        flat[:, ::5] = -7
        flat[:, 1::7] = m * cap
        flat[:, 2::11] = 2**31 - 1
    want = jax_presence_counts(jnp.asarray(flat), m * cap)
    got = presence_counts(torch.from_numpy(flat), m * cap)
    assert got.dtype == torch.float32 and got.shape == (m * cap,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, plain = embedding_bag_grad_ref(torch.from_numpy(flat).reshape(1, -1),
                                      torch.zeros((1, 0)), m * cap)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if kind == "repeated":
        assert got[cap + 17] == 32 * 26


@pytest.mark.parametrize("b,f,v,d", [(10, 5, 50, 8), (64, 26, 500, 16),
                                     (33, 3, 613, 7)])
def test_resident_plain_version_matches_pallas_resident_kernel(b, f, v, d):
    """The shapes of the JAX package's own oracle test
    (``tests/test_embedding_stream.py``): the port's resident wrapper on
    the CPU against the Pallas resident kernel in interpret mode."""
    rng = np.random.default_rng(b + 7)
    ids = rng.integers(0, v, size=(b, f)).astype(np.int32)
    grad = rng.standard_normal((b, d)).astype(np.float32)
    want_gt, want_cnt = jax_embedding_bag_grad_resident(
        jnp.asarray(ids), jnp.asarray(grad), v, interpret=True)
    gt, cnt = embedding_bag_grad_resident(torch.from_numpy(ids),
                                          torch.from_numpy(grad), v)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_allclose(gt.numpy(), np.asarray(want_gt),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


H100_SMEM_PER_BLOCK = 232_448


@pytest.mark.parametrize("d", range(0, 112))
def test_resident_plan_fits_shared_memory_at_every_width(d):
    for capacity, sms in ((500, 132), (1_000_000, 132), (1, 1)):
        threads, chunk, smem = resident_plan(capacity, d,
                                             H100_SMEM_PER_BLOCK, sms)
        blocks = -(-capacity // RESIDENT_BLOCK_V)
        assert threads == (RESIDENT_MAX_THREADS if blocks <= sms
                           else RESIDENT_FEW_THREADS)
        assert chunk % 32 == 0 and RESIDENT_MIN_CHUNK <= chunk <= threads
        assert smem == resident_smem_bytes(d, chunk) <= H100_SMEM_PER_BLOCK
        # local rows and chunk offsets are kept as uint16
        assert RESIDENT_BLOCK_V <= 1 << 16 and chunk <= 1 << 16


def test_resident_plan_refuses_a_width_past_shared_memory():
    assert resident_max_d_for(H100_SMEM_PER_BLOCK) == 111
    with pytest.raises(ValueError, match="shared memory"):
        resident_plan(500, 112, H100_SMEM_PER_BLOCK, 132)
    assert resident_plan(500, 16, H100_SMEM_PER_BLOCK, 132) == (
        1024, 1024, 43_152)


def _resident_emulation(ids, grad, v, chunk):
    """The resident kernel's walk, one vocab block at a time: chunks of
    ``chunk`` sorted entries, each cut into runs of equal ids where an id
    differs from the entry before it, each run added in entry order onto
    its row's running float32 sum; counts from the runs' lengths."""
    f = ids.shape[1]
    sorted_ids, perm = (t.numpy() for t in sort_ids(torch.from_numpy(ids), v))
    gt = np.zeros((v, grad.shape[1]), np.float32)
    cnt = np.zeros((v,), np.int64)
    for v0 in range(0, v, RESIDENT_BLOCK_V):
        lo, hi = np.searchsorted(sorted_ids, [v0, min(v0 + 512, v)])
        for c0 in range(lo, hi, chunk):
            n = min(chunk, hi - c0)
            marks = [k for k in range(n)
                     if k == 0 or sorted_ids[c0 + k] != sorted_ids[c0 + k - 1]]
            for j, s in enumerate(marks):
                e = marks[j + 1] if j + 1 < len(marks) else n
                r = sorted_ids[c0 + s]
                cnt[r] += e - s
                for k in range(s, e):
                    gt[r] = (gt[r] + grad[perm[c0 + k] // f]).astype(
                        np.float32)
    return gt, cnt.astype(np.float32)


@pytest.mark.parametrize("chunk", [32, 256, 1024])
@pytest.mark.parametrize("kind", ["uniform", "one-row", "skewed"])
def test_resident_runs_across_chunks_keep_entry_order_bit_for_bit(chunk,
                                                                  kind):
    """Cutting each chunk into runs, a run that straddles two chunks
    included, gives the entry-order sums of the plain version bit for
    bit."""
    rng = np.random.default_rng(chunk)
    ids = rng.integers(-3, 1100, size=(64, 26)).astype(np.int32)
    if kind == "one-row":
        ids[:] = 517
    elif kind == "skewed":
        ids[:, :20] = 600                   # a run of 1280 entries
    grad = (rng.standard_normal((64, 8))
            * 10.0 ** rng.integers(-6, 6, size=(64, 1))).astype(np.float32)
    want_gt, want_cnt = _kernel_emulation(ids, grad, 1100)
    got_gt, got_cnt = _resident_emulation(ids, grad, 1100, chunk)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_gt.view(np.uint32),
                                  want_gt.view(np.uint32))
    plain_gt, _ = _port(ids, grad, 1100)
    np.testing.assert_array_equal(plain_gt.view(np.uint32),
                                  want_gt.view(np.uint32))


H100_SMS = 132
REPLAY_E, REPLAY_V = 53_248, 1_600_048     # shape (a): the replay's counts

# (d, SMs): the replay's counts on an H100 SXM, on a card of 114 SMs and
# on one SM; the sparse smoke's D = 16, one-wide and wide gradients
PLAN_KINDS = {
    "counts-132-sms": (0, H100_SMS),
    "counts-114-sms": (0, 114),
    "counts-1-sm": (0, 1),
    "segment-d16": (16, H100_SMS),
    "segment-d1": (1, H100_SMS),
    "segment-d200": (200, H100_SMS),
}


@pytest.mark.parametrize("edge", ["0", "1", "tile-1", "tile", "tile+1",
                                  "replay", "int-max"])
@pytest.mark.parametrize("kind", list(PLAN_KINDS))
def test_grad_plan_covers_every_row_once(kind, edge):
    """Block b owns rows [b * tile_rows, (b + 1) * tile_rows): the blocks
    cover [0, capacity) exactly once with no empty block, at the edges of
    the tile that the plan takes at the replay's capacity, within the
    H100's thread limits; the cooperative counts launch asks for at most
    one block an SM, so its blocks are all resident at once."""
    d, sms = PLAN_KINDS[kind]
    tile_at_replay = grad_plan(REPLAY_V, d, sms)[2]
    capacity = {"0": 0, "1": 1, "tile-1": tile_at_replay - 1,
                "tile": tile_at_replay, "tile+1": tile_at_replay + 1,
                "replay": REPLAY_V, "int-max": 2**31 - 1}[edge]
    got, threads, tile, blocks = grad_plan(capacity, d, sms)
    assert got == ("segment" if d > 0 else "counts")
    assert tile >= 4 and tile % 4 == 0
    assert blocks * tile >= capacity and (blocks - 1) * tile < capacity
    assert (blocks == 0) == (capacity == 0) and blocks <= 2**31 - 1
    assert 32 <= threads <= 1024 and threads % 32 == 0
    if got == "counts":
        assert blocks <= sms and threads == COUNTS_THREADS <= 2048


def test_grad_plan_picks_by_shape_deterministically():
    """The same shape gives the same plan; the replay's counts take one
    block an SM, each zeroing and converting a slice of about 48 KB; a
    capacity of fewer than 4 rows an SM takes fewer blocks; D > 0 takes
    16 KB tiles of table gradient."""
    for d, sms in PLAN_KINDS.values():
        assert grad_plan(REPLAY_V, d, sms) == grad_plan(REPLAY_V, d, sms)
    assert grad_plan(REPLAY_V, 0, H100_SMS) == ("counts", 256, 12_124, 132)
    assert grad_plan(10, 0, H100_SMS) == ("counts", 256, 4, 3)
    assert grad_plan(1_000_000, 16, H100_SMS) == ("segment", 256, 256, 3907)
    assert grad_plan(1_000_000, 200, H100_SMS)[2] == 20


def _segment_emulation(ids, grad, v, tile_rows, threads):
    """The D > 0 kernel's walk, one tile of rows at a time: the tile's span
    of sorted entries in chunks of ``threads`` entries, each chunk starting
    on a run's first entry; a run starts where an id differs from the one
    before it, the chunk's last run ends where its id does, and the next
    chunk starts at the later of the chunk's end and that run's end.  Each
    run is summed in entry order from 0.0 and written once."""
    f = ids.shape[1]
    sorted_ids, perm = (t.numpy() for t in sort_ids(torch.from_numpy(ids), v))
    gt = np.zeros((v, grad.shape[1]), np.float32)
    cnt = np.zeros((v,), np.float32)
    written = set()
    for v0 in range(0, v, tile_rows):
        lo, hi = np.searchsorted(sorted_ids, [v0, min(v0 + tile_rows, v)])
        c0 = lo
        while c0 < hi:
            n = min(threads, hi - c0)
            starts = [c0 + t for t in range(n)
                      if t == 0 or sorted_ids[c0 + t - 1] != sorted_ids[c0 + t]]
            last = starts[-1]
            end = last + int(np.searchsorted(sorted_ids[last:hi],
                                             sorted_ids[last] + 1))
            for s, e in zip(starts, starts[1:] + [end]):
                r = int(sorted_ids[s])
                assert r not in written            # each run summed once
                written.add(r)
                acc = np.zeros(grad.shape[1], np.float32)
                for k in range(s, e):
                    acc = (acc + grad[perm[k] // f]).astype(np.float32)
                gt[r], cnt[r] = acc, e - s
            c0 = max(c0 + threads, end)
    return gt, cnt


@pytest.mark.parametrize("tile_rows,threads", [(4, 32), (64, 32),
                                               (512, 256)])
@pytest.mark.parametrize("kind", ["uniform", "one-row", "skewed", "odd"])
def test_segment_runs_across_chunks_and_tiles_keep_entry_order(
        kind, tile_rows, threads):
    """Walking each tile's span in chunks, a run longer than a chunk and
    runs at tile edges included, gives the entry-order sums of the plain
    version bit for bit, each row once."""
    rng = np.random.default_rng(threads + tile_rows)
    v = 1100
    ids = rng.integers(0, v, size=(64, 26)).astype(np.int32)
    if kind == "one-row":
        ids[:] = 517
    elif kind == "skewed":
        ids[:, :20] = 600                   # a run of 1280 entries
        ids[:, 20:] = np.minimum(rng.zipf(1.2, size=(64, 6)) - 1, v - 1)
    elif kind == "odd":
        ids[:, ::3] = -1
        ids[:, 1::5] = v
        ids[:, 2::7] = v + 9
    grad = (rng.standard_normal((64, 8))
            * 10.0 ** rng.integers(-6, 6, size=(64, 1))).astype(np.float32)
    want_gt, want_cnt = _kernel_emulation(ids, grad, v)
    got_gt, got_cnt = _segment_emulation(ids, grad, v, tile_rows, threads)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_gt.view(np.uint32),
                                  want_gt.view(np.uint32))
    plain_gt, plain_cnt = _port(ids, grad, v)
    np.testing.assert_array_equal(plain_gt.view(np.uint32),
                                  want_gt.view(np.uint32))
    np.testing.assert_array_equal(plain_cnt, want_cnt)
