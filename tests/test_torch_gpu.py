"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.  Tolerances: a pool of one id is bit-exact; f32 pools of
F > 1 allow rtol=1e-5, atol=1e-6 (the plain version sums in another
order) on tables of ``init_table``'s scale 0.01; bf16 tables are compared
in f32 within one bf16 ulp (rtol=2**-7, atol=1e-6), since both sides sum
in f32 and round once.  ``embedding_bag_grad`` sums each row in entry
order, as its plain version does on the CPU, so its table gradient is held
bit for bit to the plain version run on a CPU copy, and its counts
exactly.  ``gba_apply`` does every float32 operation of its plain version,
correctly rounded and in the same order, so its param and accumulator are
held bit for bit to the plain version on the card and on a CPU copy.  The
wire quantizers and the dequantize do so too: codes, sidebands, residual
and dequantized values are held bit for bit to their plain versions, on
the strided views the wire step hands them.  ``gba_aggregate`` and
``fused_adagrad`` do the float32 operations of their plain versions in the
same order and are held bit for bit to them; ``embedding_bag_grad_resident``
sums each row in entry order and is held bit for bit to its plain version
and to the streamed ``embedding_bag_grad``.  ``flash_decode`` splits the
cache across blocks and sums in another order than its plain version's
512-position blocks: bf16 outputs within one bf16 ulp (rtol 2**-7, atol
1e-6), f32 outputs within rtol 1e-5, atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_grad,
                                               embedding_bag_grad_resident,
                                               resident_max_d)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.fused_adagrad import fused_adagrad
from repro_torch.kernels.gba_aggregate import gba_aggregate
from repro_torch.kernels.gba_apply import gba_apply
from repro_torch.kernels.quantize import (dequantize, quantize_minmax,
                                          quantize_sign)
from repro_torch.kernels.ref import (dequantize_ref, embedding_bag_grad_ref,
                                     embedding_bag_ref, flash_decode_ref,
                                     fused_adagrad_ref,
                                     gba_aggregate_ref, gba_apply_ref,
                                     quantize_minmax_ref, quantize_sign_ref)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, f, v, d, dtype, seed=0, odd=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, v, (b, f), generator=gen, device="cuda",
                        dtype=torch.int32)
    if odd:
        ids[:, ::3] = -1
        ids[:, 1::4] = v
        ids[0] = v + 5
    table = (torch.randn((v, d), generator=gen, device="cuda")
             * 0.01).to(dtype)
    return ids, table


@pytest.mark.parametrize("b,f,v,d,dtype,odd", [
    (128, 1, 1_000_000, 64, torch.float32, False),
    (4096, 16, 1_000_000, 64, torch.float32, False),
    (64, 16, 1000, 64, torch.float32, True),
    (256, 16, 50_000, 80, torch.float32, False),
    (256, 8, 10_000, 13, torch.float32, True),
    (4096, 16, 100_000, 64, torch.bfloat16, False),
    (128, 1, 100_000, 64, torch.bfloat16, True),
    (256, 16, 10_000, 20, torch.bfloat16, False),
])
def test_kernel_matches_plain_version(b, f, v, d, dtype, odd):
    _need_card()
    ids, table = _inputs(b, f, v, d, dtype, odd=odd)
    launches = embedding_bag.launches
    out = embedding_bag(ids, table)
    torch.cuda.synchronize()
    assert embedding_bag.launches == launches + 1
    ref = embedding_bag_ref(ids, table)
    assert out.dtype == table.dtype and out.shape == (b, d)
    if f == 1:
        assert torch.equal(out, ref)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    if odd:
        assert not out[0].any()                  # a bag of no valid id


def test_pooled_lookup_counts_one_launch_per_call():
    _need_card()
    ids, table = _inputs(8, 1, 4096, 16, torch.float32)
    calls, launches = ops.kernel_calls["pooled_lookup"], embedding_bag.launches
    ops.pooled_lookup(ids, table)
    assert ops.kernel_calls["pooled_lookup"] == calls + 1
    assert embedding_bag.launches == launches + 1


def test_mixed_devices_raise():
    _need_card()
    ids, table = _inputs(4, 2, 100, 8, torch.float32)
    with pytest.raises(ValueError):
        embedding_bag(ids.cpu(), table)


def test_engine_on_the_card_matches_the_cpu_engine():
    _need_card()
    from repro_torch.convert import params_to_numpy, params_from_jax
    from repro_torch.serving import (RecsysScoringEngine, ServingConfig,
                                     StaticSource, init_scoring_params)
    params = init_scoring_params(4096, 16, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    host = params_to_numpy(params)
    cfg = ServingConfig(cache_capacity=128)
    gpu = RecsysScoringEngine(StaticSource(params_from_jax(host)), config=cfg)
    cpu = RecsysScoringEngine(StaticSource(params), config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = rng.integers(0, 256, size=(4, 8))
        np.testing.assert_allclose(gpu.score(batch), cpu.score(batch),
                                   rtol=1e-6, atol=1e-7)


def _grad_case(kind, seed=0):
    """(ids, grad_out, capacity) on the card: the training path's shapes
    and the edges of the kernel's contract."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ids(b, f, hi):
        return torch.randint(0, hi, (b, f), generator=gen, device="cuda",
                             dtype=torch.int32)

    def rows(b, d):
        return torch.randn((b, d), generator=gen, device="cuda")

    if kind == "presence":        # one quickstart global step's counts
        return ids(1, 16 * 128 * 26, 1_600_048), rows(1, 0), 1_600_048
    if kind == "presence-d1":     # the same ids with one-wide rows
        return ids(1, 16 * 128 * 26, 1_600_048), rows(1, 1), 1_600_048
    if kind == "smoke":           # the sparse smoke's backward
        return ids(4, 26, 1_000_000), rows(4, 16), 1_000_000
    if kind == "odd":
        i = ids(64, 16, 1000)
        i[:, ::3] = -1
        i[:, 1::5] = 1000
        i[:, 2::7] = 5000
        return i, rows(64, 16), 1000
    if kind == "dup":
        i = ids(64, 16, 300)
        i[:, 8:] = i[:, :8]
        i[1] = i[1, 0]
        return i, rows(64, 16), 300
    if kind == "d13":
        return ids(32, 8, 500), rows(32, 13), 500
    if kind == "empty":
        return ids(0, 26, 10), rows(0, 16), 10
    if kind == "tile-boundary":
        # D = 16 tiles hold 256 rows: runs on both sides of rows 512 and
        # 1024, one of 640 entries across three 256-entry chunks
        i = ids(64, 26, 24) + 500
        i[:, 13:] += 512
        i[::2, :20] = 511
        return i, rows(64, 16), 1100
    if kind == "odd-d0":
        i = ids(64, 16, 1000)
        i[:, ::3] = -1
        i[:, 1::5] = 1000
        i[:, 2::7] = 2**31 - 1
        return i, rows(64, 0), 1000
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["presence", "presence-d1", "smoke", "odd",
                                  "dup", "d13", "empty", "tile-boundary",
                                  "odd-d0"])
def test_grad_kernel_matches_plain_version_bit_for_bit(kind):
    """One launch; counts exact and the table gradient bit-identical to the
    plain version on a CPU copy and to the resident kernel."""
    _need_card()
    ids, grad, cap = _grad_case(kind)
    launches = embedding_bag_grad.launches
    gt, cnt = embedding_bag_grad(ids, grad, cap)
    torch.cuda.synchronize()
    assert embedding_bag_grad.launches == launches + 1
    want_gt, want_cnt = embedding_bag_grad_ref(ids.cpu(), grad.cpu(), cap)
    assert gt.shape == want_gt.shape and cnt.shape == want_cnt.shape
    assert torch.equal(cnt.cpu(), want_cnt)
    assert torch.equal(gt.cpu().view(torch.int32),
                       want_gt.view(torch.int32))
    r_gt, r_cnt = embedding_bag_grad_resident(ids, grad, cap)
    assert torch.equal(r_cnt, cnt)
    assert torch.equal(r_gt.view(torch.int32), gt.view(torch.int32))


def test_grad_counts_call_no_sort(monkeypatch):
    """At D = 0 the wrapper launches the counts kernel on the raw ids: one
    launch and no sort."""
    _need_card()
    from repro_torch.kernels import embedding_bag as eb

    def refuse(*args, **kwargs):
        raise AssertionError("a sort at D = 0")
    monkeypatch.setattr(eb, "sort_ids", refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    ids, grad, cap = _grad_case("presence")
    launches = embedding_bag_grad.launches
    gt, cnt = embedding_bag_grad(ids, grad, cap)
    torch.cuda.synchronize()
    assert embedding_bag_grad.launches == launches + 1
    assert gt.shape == (cap, 0)
    monkeypatch.undo()
    assert torch.equal(cnt.cpu(), embedding_bag_grad_ref(
        ids.cpu(), grad.cpu(), cap)[1])


def _counts_case(kind):
    """(ids, capacity) for the counts kernel: the plan's tile edges at the
    replay's (1, 53,248) ids, the replay's capacity, one id repeated
    53,248 times and 2**24 times (the most a call takes), ids that start
    off a 16-byte boundary, few ids."""
    from repro_torch.kernels import embedding_bag as eb
    gen = torch.Generator(device="cuda").manual_seed(13)
    e, replay = 16 * 128 * 26, 1_600_048
    tile = eb.device_grad_plan(torch.cuda.current_device(), replay, 0)[2]
    cap = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(
        kind, replay)
    ids = torch.randint(-3, cap + 3, (1, e), generator=gen, device="cuda",
                        dtype=torch.int32)
    if kind == "one-id":
        ids[:] = 1_234_567
    elif kind == "one-id-2**24":
        ids = torch.full((1, 2**24), 1_234_567, dtype=torch.int32,
                         device="cuda")
    elif kind == "misaligned":              # 4 bytes past a 16-byte boundary
        ids = torch.randint(0, cap, (e + 1,), generator=gen, device="cuda",
                            dtype=torch.int32)[1:].reshape(1, e)
    elif kind == "few-ids":
        ids = ids[:, :7].contiguous()
    return ids, cap


@pytest.mark.parametrize("kind", ["1", "tile-1", "tile", "tile+1", "replay",
                                  "one-id", "one-id-2**24", "misaligned",
                                  "few-ids"])
def test_grad_counts_kernel_is_exact(kind):
    """The counts kernel equals the plain version exactly at the edges of
    the plan's tiles and on skewed and unaligned ids and on one id
    repeated 2**24 times, one launch each."""
    _need_card()
    from repro_torch.kernels.embedding_bag import embedding_bag_grad_counts
    ids, cap = _counts_case(kind)
    launches = embedding_bag_grad.launches
    got = embedding_bag_grad_counts(ids, cap)
    torch.cuda.synchronize()
    assert embedding_bag_grad.launches == launches + 1
    want = embedding_bag_grad_ref(ids.cpu(), torch.zeros((1, 0)), cap)[1]
    assert torch.equal(got.cpu(), want)
    if kind.startswith("one-id"):
        assert got[1_234_567].item() == ids.numel()
        assert got.sum().item() == ids.numel()


def test_grad_calls_on_two_streams_at_once():
    """Counts calls and D > 0 calls, queued on two streams and released
    together so that they run at the same time, each stay equal to the
    plain version."""
    _need_card()
    from repro_torch.kernels.embedding_bag import embedding_bag_grad_counts
    ids, cap = _counts_case("replay")
    s_ids, s_grad, s_cap = _grad_case("smoke")
    want = embedding_bag_grad_ref(ids.cpu(), torch.zeros((1, 0)), cap)[1]
    s_want = embedding_bag_grad_ref(s_ids.cpu(), s_grad.cpu(), s_cap)
    torch.cuda.synchronize()
    gate, streams = torch.cuda.Stream(), [torch.cuda.Stream()
                                          for _ in range(2)]
    with torch.cuda.stream(gate):
        torch.cuda._sleep(50_000_000)         # until every call is queued
    released = gate.record_event()
    for s in streams:
        s.wait_event(released)
    counts, grads = [], []
    for i in range(12):
        with torch.cuda.stream(streams[i % 2]):
            counts.append(embedding_bag_grad_counts(ids, cap))
            grads.append(embedding_bag_grad(s_ids, s_grad, s_cap))
    torch.cuda.synchronize()
    for got in counts:
        assert torch.equal(got.cpu(), want)
    for gt, cnt in grads:
        assert torch.equal(cnt.cpu(), s_want[1])
        assert torch.equal(gt.cpu().view(torch.int32),
                           s_want[0].view(torch.int32))


@pytest.mark.parametrize("cap", [12_123, 12_124, 12_125, 1_600_048,
                                 2**31 - 1])
def test_grad_plan_launch_fits_the_card(cap):
    """The plan's launches run on the card up to the largest capacity:
    the cooperative counts launch (all its blocks resident) and, where
    the table gradient fits, the D = 16 launch; the rows of every valid
    id hold its count and the counts sum to the valid ids."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(17)
    ids = torch.randint(-3, min(cap + 3, 2**31 - 1), (4, 26), generator=gen,
                        device="cuda", dtype=torch.int32)
    ids[0, :4] = torch.tensor([0, cap - 1, cap - 1, 2**31 - 1])
    valid = ids[(ids >= 0) & (ids < cap)]
    rows, times = torch.unique(valid, return_counts=True)
    grads = [torch.zeros((4, 0), device="cuda")]
    if cap * 16 * 4 < 2**31:
        grads.append(torch.randn((4, 16), generator=gen, device="cuda"))
    for grad in grads:
        gt, cnt = embedding_bag_grad(ids, grad, cap)
        torch.cuda.synchronize()
        assert cnt.shape == (cap,) and gt.shape == (cap, grad.shape[1])
        assert torch.equal(cnt[rows.long()], times.float())
        assert cnt.sum().item() == valid.numel()
        if grad.shape[1]:
            want = embedding_bag_grad_ref(ids.cpu(), grad.cpu(), cap)[0]
            assert torch.equal(gt.cpu().view(torch.int32),
                               want.view(torch.int32))
        del gt, cnt


def test_grad_mixed_devices_raise():
    _need_card()
    ids, grad, cap = _grad_case("odd")
    with pytest.raises(ValueError):
        embedding_bag_grad(ids.cpu(), grad, cap)


@pytest.mark.parametrize("kind", ["dup", "smoke"])
def test_pooled_lookup_autograd_launches_both_kernels(kind):
    _need_card()
    from repro_torch.embeddings import EmbeddingTable, pooled_lookup
    ids, grad, cap = _grad_case(kind)
    table = (torch.randn((cap, 16), device="cuda") * 0.01).requires_grad_()
    fwd, bwd = embedding_bag.launches, embedding_bag_grad.launches
    pooled = pooled_lookup(EmbeddingTable(table, None), ids)
    (gt,) = torch.autograd.grad(pooled, table, grad)
    assert (embedding_bag.launches, embedding_bag_grad.launches) == (
        fwd + 1, bwd + 1)
    torch.testing.assert_close(pooled.detach(),
                               embedding_bag_ref(ids, table.detach()),
                               rtol=1e-5, atol=1e-6)
    zero = torch.zeros_like(table, requires_grad=True)
    (want,) = torch.autograd.grad(embedding_bag_ref(ids, zero), zero, grad)
    torch.testing.assert_close(gt, want, rtol=1e-6, atol=1e-7)


def test_replay_on_the_card_matches_the_cpu():
    _need_card()
    from repro_torch.configs.recsys import CRITEO_DEEPFM
    from repro_torch.convert import params_to_numpy, tree_to_device
    from repro_torch.core import GBATrainer
    from repro_torch.data import make_clickstream
    from repro_torch.models.recsys import init_recsys
    from repro_torch.optim import get_optimizer
    from repro_torch.sim.cluster import Schedule, Slot
    cfg = dataclasses.replace(CRITEO_DEEPFM, hash_capacity=2048,
                              mlp_dims=(32, 16))
    steps = [[Slot(k * 3 + i, max(0, k - i), max(0, k - i),
                   1.0 if i < 2 else 0.0) for i in range(3)]
             for k in range(4)]
    params = init_recsys(cfg, generator=torch.Generator().manual_seed(2),
                         device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        opt = get_optimizer("sgd", 0.05)
        p = tree_to_device(params, torch.device(dev))
        launches = embedding_bag_grad.launches
        out[dev] = GBATrainer(cfg, opt, iota=1).replay(
            p, opt.init(p), Schedule("gba", 32, steps),
            make_clickstream(cfg, seed=0, batch_size=32), 0)
        assert embedding_bag_grad.launches == launches + (
            4 if dev == "cuda" else 0)
    (pc, _, luc, stc), (pg, _, lug, stg) = out["cpu"], out["cuda"]
    assert torch.equal(luc, lug.cpu())
    assert (stc.kept_slots, stc.dropped_slots, stc.embed_rows_rescued) == (
        stg.kept_slots, stg.dropped_slots, stg.embed_rows_rescued)
    np.testing.assert_allclose(stg.losses, stc.losses, rtol=1e-5)
    got, want = params_to_numpy(pg), params_to_numpy(pc)
    for k in ("embed", "linear", "bias"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)


def _apply_case(kind, seed=0):
    """(param, accum, buffer, tokens, step) on the card: the fused LM
    step's layout at a small N and the edges of the kernel's contract."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m, n, p_dt, b_dt, ages = {
        "path": (4, 1 << 20, torch.float32, torch.float32, [0, 0, 0, 0]),
        "ragged-stale-bf16-param": (3, 5000, torch.bfloat16, torch.float32,
                                    [0, 5, 1]),
        "all-stale-scalar": (4, 4099, torch.float32, torch.float32,
                             [5, 6, 7, 9]),
        "bf16-buffer": (4, 8192, torch.float32, torch.bfloat16,
                        [0, 1, 4, 5]),
        "bf16-both-scalar": (8, 10_001, torch.bfloat16, torch.bfloat16,
                             [0, 1, 2, 3, 4, 5, 6, 7]),
    }[kind]
    step = 9
    param = torch.randn((n,), generator=gen, device="cuda").to(p_dt)
    accum = 0.1 + torch.rand((n,), generator=gen, device="cuda")
    buffer = torch.randn((m, n), generator=gen, device="cuda").to(b_dt)
    tokens = torch.tensor([step - a for a in ages], dtype=torch.int32,
                          device="cuda")
    return param, accum, buffer, tokens, step


@pytest.mark.parametrize("kind", ["path", "ragged-stale-bf16-param",
                                  "all-stale-scalar", "bf16-buffer",
                                  "bf16-both-scalar"])
def test_gba_apply_matches_plain_version_bit_for_bit(kind):
    _need_card()
    param, accum, buffer, tokens, step = _apply_case(kind)
    lr, iota = 1e-3, 4
    want_p, want_a = gba_apply_ref(param, accum, buffer, tokens, step, lr,
                                   iota=iota)
    host_p, host_a = gba_apply_ref(param.cpu(), accum.cpu(), buffer.cpu(),
                                   tokens.cpu(), step, lr, iota=iota)
    before_p, before_a = param.clone(), accum.clone()
    launches = gba_apply.launches
    p, a = gba_apply(param, accum, buffer, tokens, step, lr, iota=iota)
    torch.cuda.synchronize()
    assert gba_apply.launches == launches + 1
    assert p is param and a is accum
    bits = torch.int16 if param.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(param.view(bits), want_p.view(bits))
    assert torch.equal(accum.view(torch.int32), want_a.view(torch.int32))
    assert torch.equal(param.cpu().view(bits), host_p.view(bits))
    assert torch.equal(accum.cpu().view(torch.int32),
                       host_a.view(torch.int32))
    if kind == "all-stale-scalar":
        assert torch.equal(param, before_p) and torch.equal(accum, before_a)
    else:
        assert not torch.equal(accum, before_a)


def test_gba_apply_mixed_devices_raise():
    _need_card()
    param, accum, buffer, tokens, step = _apply_case("path")
    with pytest.raises(ValueError):
        gba_apply(param, accum.cpu(), buffer, tokens, step, 1e-3, iota=4)
    strided = torch.empty((buffer.shape[1], buffer.shape[0]),
                          device="cuda").t()             # (M, N), not contiguous
    with pytest.raises(ValueError):
        gba_apply(param, accum, strided, tokens, step, 1e-3, iota=4)


def test_fused_lm_step_on_the_card_matches_the_cpu():
    _need_card()
    import dataclasses as dc
    from repro_torch.configs import GBAConfig, get_config
    from repro_torch.convert import tree_to_device
    from repro_torch.data import make_lm_stream
    from repro_torch.launch.programs import build_programs
    from repro_torch.models.transformer import init_model
    cfg = dc.replace(get_config("granite-8b").reduced(), dtype="float32")
    host = init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    gba = GBAConfig(local_batch=2, buffer_size=4, staleness_tolerance=4)
    stream = make_lm_stream(cfg.vocab_size, 32, 2, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        progs = build_programs(cfg, gba, params=tree_to_device(
            host, torch.device(dev)))
        state, losses = progs.state, []
        launches = gba_apply.launches
        for i in range(4):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(i).items()}
            state, loss = progs.step(state, b, 0)
            losses.append(loss.item())
        assert gba_apply.launches == launches + (dev == "cuda")
        runs[dev] = (losses, progs.layout.ravel(state["params"]).cpu(),
                     state["accum"].cpu())
    (lc, pc, ac), (lg, pg, ag) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    torch.testing.assert_close(pg, pc, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ag, ac, rtol=1e-5, atol=1e-7)


def _wire_view(r, lead, off, cols, tile, seed):
    """An (r, cols) float32 view at column ``off`` of an (r, lead) buffer
    on the card: normal draws scaled by 10**k per tile (k in -20..5), a
    constant tile, a tile of signed zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((r, lead), generator=gen, device="cuda")
    view = buf[:, off:off + cols]
    scale = 10.0 ** torch.randint(-20, 6, (r, cols // tile, 1),
                                  generator=gen, device="cuda")
    view.copy_((view.reshape(r, cols // tile, tile) * scale).reshape(r, cols))
    view[0, :tile] = 1.5
    if cols // tile > 1:
        view[-1, tile:2 * tile] = 0.0
        view[-1, tile + 1:2 * tile:3] = -0.0
    return buf, view


# (rows, buffer width, column offset, columns, tile): the wire step's
# layouts at a small width (worker w's residual row of S shards, group g's
# columns), a ragged tile, and a view whose last bytes lie beyond 2**31
# bytes of the buffer behind it
WIRE_CASES = {
    "group-of-4-shards": (4, 2048 * 12, 2048 * 5, 2048 * 6, 2048),
    "single-tile-group": (4, 2048 * 3, 2048 * 2, 2048, 2048),
    "tile-256": (3, 256 * 20, 256 * 7, 256 * 9, 256),
    "tile-300": (2, 300 * 10, 300, 300 * 8, 300),
    "beyond-2**31-bytes": (4, 140_000_000, 139_000_000 - 139_000_000 % 2048,
                           2048 * 64, 2048),
}


@pytest.mark.parametrize("mode", ["minmax", "sign"])
@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_quantize_matches_plain_version_bit_for_bit(case, mode):
    _need_card()
    r, lead, off, cols, tile = WIRE_CASES[case]
    buf, view = _wire_view(r, lead, off, cols, tile, seed=len(case))
    before = buf.clone()
    want = (quantize_minmax_ref if mode == "minmax" else
            quantize_sign_ref)(view.clone(), tile)
    host = (quantize_minmax_ref if mode == "minmax" else
            quantize_sign_ref)(view.cpu(), tile)
    kernel = quantize_minmax if mode == "minmax" else quantize_sign
    launches = kernel.launches
    got = kernel(view, tile=tile)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    for name, g, w, h in zip(("q", "scale", "zero", "residual"),
                             (*got, view), want, host):
        bits = torch.int8 if g.dtype == torch.int8 else torch.int32
        assert torch.equal(g.view(bits), w.view(bits)), name
        assert torch.equal(g.cpu().view(bits), h.view(bits)), name
    # nothing outside the view was written
    assert torch.equal(buf[:, :off], before[:, :off])
    assert torch.equal(buf[:, off + cols:], before[:, off + cols:])


@pytest.mark.parametrize("mode", ["minmax", "sign"])
@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_dequantize_matches_plain_version_bit_for_bit(case, mode):
    """Codes, sidebands and output as strided views, the way a shard
    reads group g's columns of its routed buffers and writes them into
    its (M, shard_size) block."""
    _need_card()
    r, lead, off, cols, tile = WIRE_CASES[case]
    _, view = _wire_view(r, lead, off, cols, tile, seed=7)
    kernel = quantize_minmax if mode == "minmax" else quantize_sign
    q0, *sides0 = kernel(view.clone(), tile=tile)
    codes = torch.zeros((r, lead), dtype=torch.int8, device="cuda")
    codes[:, off:off + cols] = q0
    t0, nt = off // tile, cols // tile
    sides = []
    for s0 in sides0:
        s = torch.zeros((r, lead // tile + 1), device="cuda")
        s[:, t0:t0 + nt] = s0
        sides.append(s[:, t0:t0 + nt])
    zero = sides[1] if mode == "minmax" else None
    out_buf = torch.full((r, lead), 7.0, device="cuda")
    out = out_buf[:, off:off + cols]
    q = codes[:, off:off + cols]
    want = dequantize_ref(q, sides[0], zero, tile, mode)
    launches = dequantize.launches
    dequantize(q, sides[0], zero, tile=tile, mode=mode, out=out)
    torch.cuda.synchronize()
    assert dequantize.launches == launches + 1
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert (out_buf[:, :off] == 7).all() and (out_buf[:, off + cols:] == 7
                                              ).all()


def test_quantize_mixed_devices_raise():
    _need_card()
    x = torch.zeros((2, 512), device="cuda")
    q, s = quantize_sign(x.clone(), tile=256)
    with pytest.raises(ValueError):
        dequantize(q, s.cpu(), None, tile=256, mode="sign", out=x)
    with pytest.raises(ValueError):
        quantize_minmax(x.t().contiguous().t(), tile=256)


def test_wire_step_on_the_card_matches_the_cpu():
    """granite-8b.reduced() in float32, 4 workers, int8 and onebit, 2 warm
    and 2 compressed global steps, card against CPU from the same params:
    launch counts per step, losses within 1e-5 (float32 sum orders; a code
    that flips at a rounding boundary moves one routed value by one
    quantization step)."""
    _need_card()
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_to_device
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    cfg = dc.replace(get_config("granite-8b").reduced(), dtype="float32")
    host = init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    for scheme in ("int8", "onebit"):
        quant = quantize_minmax if scheme == "int8" else quantize_sign
        runs = {}
        for dev in ("cpu", "cuda"):
            counts = []

            def on_step(i, progs, counts=counts):
                counts.append((quant.launches, dequantize.launches,
                               gba_apply.launches))
            before = (quant.launches, dequantize.launches,
                      gba_apply.launches)
            losses = train.run_wire_train(
                cfg, workers=4, scheme=scheme, steps=4, compress_warmup=2,
                device=dev, params=tree_to_device(host, torch.device(dev)),
                on_step=on_step)
            steps = [tuple(b - a for a, b in zip(x, y))
                     for x, y in zip([before] + counts, counts)]
            on_card = dev == "cuda"
            assert steps == [(0, 0, 4 * on_card)] * 2 + [
                (16 * on_card, 16 * on_card, 4 * on_card)] * 2
            runs[dev] = losses
        np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-5)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


AGGREGATE_CASES = {   # M, D, dtype, slot ages against iota 4
    "path-leaf-bf16": (4, 1 << 20, torch.bfloat16, [0, 0, 0, 0]),
    "ragged-stale": (3, 5001, torch.float32, [0, 5, 1]),
    "m1": (1, 4099, torch.float32, [0]),
    "m1-dropped": (1, 4099, torch.float32, [7]),
    "all-dropped": (4, 8192, torch.float32, [5, 6, 7, 9]),
    "bf16-odd": (8, 10_001, torch.bfloat16, list(range(8))),
}


@pytest.mark.parametrize("kind", list(AGGREGATE_CASES))
def test_gba_aggregate_matches_plain_version_bit_for_bit(kind):
    _need_card()
    m, d, dt, ages = AGGREGATE_CASES[kind]
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = torch.randn((m, d), generator=gen, device="cuda").to(dt)
    step = 9
    tokens = torch.tensor([step - a for a in ages], dtype=torch.int32,
                          device="cuda")
    launches = gba_aggregate.launches
    out = gba_aggregate(grads, tokens, step, iota=4)
    torch.cuda.synchronize()
    assert gba_aggregate.launches == launches + 1
    want = gba_aggregate_ref(grads, tokens, step, iota=4)
    host = gba_aggregate_ref(grads.cpu(), tokens.cpu(), step, iota=4)
    assert out.dtype == dt and out.shape == (d,)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(out.cpu()), _bits(host))
    if all(a > 4 for a in ages):
        # +0.0 from the sum, as XLA's; at M = 1 the product's signed zero
        assert not out.any()
        assert bool(torch.signbit(out).any()) == (m == 1)


def test_gba_aggregate_offsets_beyond_2_31_elements():
    """M * D > 2**31: the last slot starts past int32's reach.  Columns are
    independent, so the plain version runs on the first and last columns
    alone."""
    _need_card()
    m, d = 4, (1 << 29) + 12
    grads = torch.empty((m, d), dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for j in range(m):
        grads[j].normal_(generator=gen)
    tokens = torch.tensor([9, 9, 3, 9], dtype=torch.int32, device="cuda")
    out = gba_aggregate(grads, tokens, 9, iota=4)
    torch.cuda.synchronize()
    for cols in (slice(0, 1 << 20), slice(d - (1 << 20), d)):
        want = gba_aggregate_ref(grads[:, cols].contiguous(), tokens, 9,
                                 iota=4)
        assert torch.equal(_bits(out[cols]), _bits(want))


ADAGRAD_CASES = {   # N, param dtype, grad dtype
    "path-leaf": (1 << 20, torch.bfloat16, torch.bfloat16),
    "f32-ragged-scalar": (5001, torch.float32, torch.float32),
    "bf16-param-f32-grad": (8192, torch.bfloat16, torch.float32),
    "f32-param-bf16-grad-odd": (4099, torch.float32, torch.bfloat16),
}


@pytest.mark.parametrize("kind", list(ADAGRAD_CASES))
def test_fused_adagrad_matches_plain_version_bit_for_bit(kind):
    _need_card()
    n, p_dt, g_dt = ADAGRAD_CASES[kind]
    gen = torch.Generator(device="cuda").manual_seed(3)
    param = (torch.randn((n,), generator=gen, device="cuda") * 0.02).to(p_dt)
    grad = (torch.randn((n,), generator=gen, device="cuda") * 1e-3).to(g_dt)
    accum = 0.1 + torch.rand((n,), generator=gen, device="cuda")
    want_p, want_a = fused_adagrad_ref(param, grad, accum, 1e-3)
    host_p, host_a = fused_adagrad_ref(param.cpu(), grad.cpu(), accum.cpu(),
                                       1e-3)
    launches = fused_adagrad.launches
    p, a = fused_adagrad(param, grad, accum, 1e-3)
    torch.cuda.synchronize()
    assert fused_adagrad.launches == launches + 1
    assert p is param and a is accum          # in place, as the TPU aliases
    assert torch.equal(_bits(param), _bits(want_p))
    assert torch.equal(_bits(accum), _bits(want_a))
    assert torch.equal(_bits(param.cpu()), _bits(host_p))
    assert torch.equal(_bits(accum.cpu()), _bits(host_a))


def test_tree_ops_on_the_card_launch_once_a_leaf_and_alias_nothing():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = {"w": torch.randn((33, 7), generator=gen, device="cuda"),
              "b": {"c": torch.randn((129,), generator=gen,
                                     device="cuda").bfloat16()}}
    stacked = {"w": torch.randn((4, 33, 7), generator=gen, device="cuda"),
               "b": {"c": torch.randn((4, 129), generator=gen,
                                      device="cuda").bfloat16()}}
    accums = {"w": torch.full((33, 7), 0.1, device="cuda"),
              "b": {"c": torch.full((129,), 0.1, device="cuda")}}
    tokens = torch.tensor([5, 0, 4, 5], dtype=torch.int32, device="cuda")
    n_agg, n_ada = gba_aggregate.launches, fused_adagrad.launches
    agg = ops.gba_aggregate_tree(stacked, tokens, 5, iota=2)
    before = {"w": params["w"].clone(), "c": params["b"]["c"].clone(),
              "a": accums["w"].clone()}
    new_p, new_a = ops.adagrad_apply_tree(params, agg, accums, 1e-3)
    torch.cuda.synchronize()
    assert (gba_aggregate.launches, fused_adagrad.launches) == (n_agg + 2,
                                                                n_ada + 2)
    assert torch.equal(params["w"], before["w"])
    assert torch.equal(_bits(params["b"]["c"]), _bits(before["c"]))
    assert torch.equal(accums["w"], before["a"])
    want_p, want_a = fused_adagrad_ref(
        params["w"].reshape(-1), gba_aggregate_ref(
            stacked["w"].reshape(4, -1), tokens, 5, iota=2),
        accums["w"].reshape(-1), 1e-3)
    assert torch.equal(new_p["w"].reshape(-1), want_p)
    assert torch.equal(new_a["w"].reshape(-1), want_a)
    assert new_p["b"]["c"].dtype == torch.bfloat16


RESIDENT_CASES = {   # B, F, V, D
    "stream-test-a": (10, 5, 50, 8),
    "stream-test-b": (64, 26, 500, 16),
    "stream-test-c": (33, 3, 613, 7),
    "smoke": (4, 26, 1_000_000, 16),
    "presence-counts": (1, 16 * 128 * 26, 1_600_048, 0),
    "odd-ids-d13": (64, 16, 1000, 13),
}


@pytest.mark.parametrize("kind", list(RESIDENT_CASES))
def test_resident_grad_matches_plain_and_streamed_bit_for_bit(kind):
    _need_card()
    b, f, v, d = RESIDENT_CASES[kind]
    gen = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, v, (b, f), generator=gen, device="cuda",
                        dtype=torch.int32)
    if kind.startswith("odd"):
        ids[:, ::3] = -1
        ids[:, 1::5] = v
        ids[:, 2::7] = v + 77
    grad = torch.randn((b, d), generator=gen, device="cuda")
    launches = embedding_bag_grad_resident.launches
    gt, cnt = embedding_bag_grad_resident(ids, grad, v)
    torch.cuda.synchronize()
    assert embedding_bag_grad_resident.launches == launches + 1
    want_gt, want_cnt = embedding_bag_grad_ref(ids.cpu(), grad.cpu(), v)
    s_gt, s_cnt = embedding_bag_grad(ids, grad, v)
    assert torch.equal(cnt.cpu(), want_cnt) and torch.equal(cnt, s_cnt)
    assert torch.equal(gt.cpu().view(torch.int32), want_gt.view(torch.int32))
    assert torch.equal(gt.view(torch.int32), s_gt.view(torch.int32))


def test_resident_grad_takes_d_up_to_shared_memory_and_refuses_one_more():
    _need_card()
    d = resident_max_d()
    assert d >= 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, 2000, (256, 8), generator=gen, device="cuda",
                        dtype=torch.int32)
    grad = torch.randn((256, d), generator=gen, device="cuda")
    gt, cnt = embedding_bag_grad_resident(ids, grad, 2000)
    torch.cuda.synchronize()
    want_gt, want_cnt = embedding_bag_grad_ref(ids.cpu(), grad.cpu(), 2000)
    assert torch.equal(gt.cpu().view(torch.int32), want_gt.view(torch.int32))
    assert torch.equal(cnt.cpu(), want_cnt)
    launches = embedding_bag_grad_resident.launches
    wide = torch.randn((256, d + 1), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        embedding_bag_grad_resident(ids, wide, 2000)
    assert embedding_bag_grad_resident.launches == launches


def _resident_held(ids, grad, v):
    """The resident kernel against its plain version on a CPU copy and the
    streamed kernel, bit for bit, with one launch."""
    launches = embedding_bag_grad_resident.launches
    gt, cnt = embedding_bag_grad_resident(ids, grad, v)
    torch.cuda.synchronize()
    assert embedding_bag_grad_resident.launches == launches + 1
    assert gt.shape == (v, grad.shape[1]) and cnt.shape == (v,)
    want_gt, want_cnt = embedding_bag_grad_ref(ids.cpu(), grad.cpu(), v)
    s_gt, s_cnt = embedding_bag_grad(ids, grad, v)
    assert torch.equal(cnt.cpu(), want_cnt) and torch.equal(cnt, s_cnt)
    assert torch.equal(gt.cpu().view(torch.int32), want_gt.view(torch.int32))
    assert torch.equal(gt.view(torch.int32), s_gt.view(torch.int32))
    return gt, cnt


def _resident_edge(kind):
    gen = torch.Generator(device="cuda").manual_seed(11)
    d = {"d0": 0, "d1": 1, "max-d": resident_max_d(), "e0": 16}.get(kind, 16)
    b, f, v = 64, 26, 500
    if kind.startswith("straddle"):
        # one row's run covers entries 1000 .. 1279 of the sorted order:
        # across the 1024-entry chunk of a one-block launch, or across the
        # 256-entry chunks of a many-block one
        v = 500 if kind == "straddle-one-block" else 100_000
        ids = torch.arange(b * f, device="cuda", dtype=torch.int32) // 10
        ids[1000:1280] = 100
        ids = ids.reshape(b, f)[torch.randperm(b, generator=gen,
                                               device="cuda")]
    elif kind == "one-row":
        ids = torch.full((b, f), 7, device="cuda", dtype=torch.int32)
    elif kind == "empty-block":                 # rows 512 .. 1023 get none
        v = 2000
        ids = torch.randint(0, 1488, (b, f), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.where(ids >= 512, ids + 512, ids)
    elif kind == "v-1025":
        v = 1025
        ids = torch.randint(0, v, (b, f), generator=gen, device="cuda",
                            dtype=torch.int32)
    elif kind == "e0":
        b, f = 3, 0
        ids = torch.zeros((b, f), device="cuda", dtype=torch.int32)
    else:
        ids = torch.randint(-2, v + 2, (b, f), generator=gen, device="cuda",
                            dtype=torch.int32)
    return ids, torch.randn((b, d), generator=gen, device="cuda"), v


@pytest.mark.parametrize("kind", ["straddle-one-block", "straddle-many",
                                  "one-row", "empty-block", "d0", "d1",
                                  "max-d", "v-1025", "e0"])
def test_resident_grad_edges_match_plain_and_streamed_bit_for_bit(kind):
    _need_card()
    ids, grad, v = _resident_edge(kind)
    gt, cnt = _resident_held(ids, grad, v)
    if kind == "empty-block":
        assert not gt[512:1024].any() and not cnt[512:1024].any()
    if kind == "one-row":
        assert cnt[7] == ids.numel() and cnt.sum() == ids.numel()
    if kind == "e0":
        assert not gt.any() and not cnt.any()


def test_pytree_lm_step_on_the_card_matches_the_cpu():
    """granite-8b.reduced() in float32, Adam, 2 global steps at M = 4 from
    the same params, card against CPU: losses within rtol 1e-4 and params
    within atol 2e-3 (twice lr: Adam moves an element by about lr whatever
    the size of its gradient)."""
    _need_card()
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_to_device
    from repro_torch.core.gba import FlatLayout
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    cfg = dc.replace(get_config("granite-8b").reduced(), dtype="float32")
    host = init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    layout = FlatLayout.from_params(host)
    runs = {}
    for dev in ("cpu", "cuda"):
        final = {}

        def on_step(i, progs, seconds, final=final):
            final["params"] = progs.state["params"]
            final["gstep"] = progs.state["gstep"]
        losses = train.run_lm_pytree(
            cfg, steps=8, batch=2, seq=32, device=dev,
            params=tree_to_device(host, torch.device(dev)), on_step=on_step)
        assert final["gstep"] == 2
        runs[dev] = (losses, layout.ravel(final["params"]).cpu())
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    torch.testing.assert_close(pg, pc, rtol=0, atol=2e-3)


# (B, L, KV, G, hd, dtype): chip_smoke.py phase 13(e)'s shapes and edges
FLASH_CASES = {
    "serve loop (4, 160, 8, 4, 128) bf16": (4, 160, 8, 4, 128,
                                            torch.bfloat16),
    "decode_32k (4, 32768, 8, 4, 128) bf16": (4, 32_768, 8, 4, 128,
                                              torch.bfloat16),
    "ragged L = 544 bf16": (4, 544, 8, 4, 128, torch.bfloat16),
    "G = 1": (2, 544, 8, 1, 128, torch.bfloat16),
    "f32 (4, 4096, 8, 4, 128)": (4, 4096, 8, 4, 128, torch.float32),
    "reduced granite, hd 64, G 1, f32": (4, 25, 4, 1, 64, torch.float32),
    "hd 256, G 8": (1, 700, 2, 8, 256, torch.bfloat16),
    "G = 3, run as 4": (2, 300, 2, 3, 128, torch.bfloat16),
    "G = 5, run as 8": (2, 300, 2, 5, 128, torch.bfloat16),
    "hd 64 bf16": (2, 700, 4, 4, 64, torch.bfloat16),
    "L = 40, less than one stage": (3, 40, 2, 4, 128, torch.bfloat16),
}


def _flash_inputs(b, length, kv, g, hd, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, kv, g, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                    dtype=dtype)
    v = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                    dtype=dtype)
    return q, k, v


def _flash_close(got, want):
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("where", ["0", "1000", "L - 1"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_decode_matches_plain_version(case, where):
    _need_card()
    b, length, kv, g, hd, dtype = FLASH_CASES[case]
    q, k, v = _flash_inputs(b, length, kv, g, hd, dtype)
    pos = {"0": 0, "1000": 1000, "L - 1": length - 1}[where]
    launches = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                             device="cuda"))
    torch.cuda.synchronize()
    assert flash_decode.launches == launches + 1
    assert got.dtype == dtype and got.shape == q.shape
    _flash_close(got, flash_decode_ref(q, k, v, pos))


def test_flash_decode_masks_everything_below_zero_as_the_tpu_kernel():
    """pos < 0 masks every position: all scores are -1e30 and the output
    is the mean of v, as in the TPU kernel and the plain version."""
    _need_card()
    q, k, v = _flash_inputs(2, 300, 2, 4, 64, torch.float32)
    got = flash_decode(q, k, v, -1)
    _flash_close(got, flash_decode_ref(q, k, v, -1))
    mean = v.mean(dim=1)[:, :, None, :].expand_as(got)
    torch.testing.assert_close(got, mean, rtol=1e-5, atol=1e-6)


def test_flash_decode_refuses_what_the_kernel_does_not_take():
    _need_card()
    q, k, v = _flash_inputs(2, 256, 2, 4, 128, torch.bfloat16)
    launches = flash_decode.launches
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 3)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        flash_decode(q, k.cpu(), v, 3)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        flash_decode(q, k, v, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")
        flash_decode(q, flat[1:].view(k.shape), v, 3)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     v[..., :32].contiguous(), 3)
    assert flash_decode.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_batch_decode_through_the_kernel_matches_the_plain_version(
        dtype, monkeypatch):
    """granite-8b.reduced() at depth 2 on the card: prefill and 8 decode
    steps at a scalar position, once through the kernel and once with
    ``ops.flash_decode`` swapped for the plain version, both fed the
    kernel run's tokens.  float32: logits within 1e-5 of the largest and
    the greedy tokens equal; bfloat16: logits within 2**-6 of the
    largest (the attention outputs may round one bf16 ulp apart)."""
    _need_card()
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dc.replace(get_config("granite-8b").reduced(), dtype=dtype,
                     num_layers=2)
    params = T.init_model(cfg, generator=torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))

    def run(tokens=None):
        logits, cache = T.prefill(params, cfg, prompts, cache_len=24)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out, seen = [tok], []
        for i in range(8):
            lg, cache = T.decode_step(params, cfg, tok if tokens is None
                                      else tokens[:, i:i + 1], cache)
            seen.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, 1), torch.cat(seen, 1)

    launches = flash_decode.launches
    tokens, logits = run()
    assert flash_decode.launches == launches + 2 * 8
    monkeypatch.setattr(ops, "flash_decode", flash_decode_ref)
    plain_tokens, plain_logits = run(tokens)
    assert flash_decode.launches == launches + 2 * 8
    frac = 1e-5 if dtype == "float32" else 2.0**-6
    err = (logits - plain_logits).abs().max().item()
    assert err <= frac * plain_logits.abs().max().item(), err
    if dtype == "float32":
        assert torch.equal(tokens, plain_tokens)


def test_serve_decode_on_the_card_matches_the_cpu():
    """granite-8b.reduced() in float32, the fixed-batch loop: the card
    (kernel) against the CPU (plain version), tokens equal."""
    _need_card()
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_to_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dc.replace(get_config("granite-8b").reduced(), dtype="float32")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    runs = {dev: serve.run_fixed_batch(
        tree_to_device(host, torch.device(dev)), cfg,
        prompts.to(dev), 9, log=lambda _: None)["tokens"].cpu()
        for dev in ("cpu", "cuda")}
    assert torch.equal(runs["cpu"], runs["cuda"])


def _ring_chunk(b, length, kv, hd):
    from repro_torch.kernels.flash_decode import _device, ring_plan
    sms, smem = _device(torch.cuda.current_device())
    return ring_plan(length, b * kv, sms, hd, smem)


@pytest.mark.parametrize("where", ["tile - 1", "tile", "split - 1", "split",
                                   "split + tile + 1", "last split only"])
def test_flash_decode_bf16_at_tile_and_split_boundaries(where):
    """Positions at the edges of the ring's 64-position stages and of the
    splits of the plan, held to the plain version."""
    _need_card()
    b, length, kv, g, hd = 4, 8192, 8, 4, 128
    chunk, nsplit, _, _ = _ring_chunk(b, length, kv, hd)
    assert nsplit > 2 and chunk > 64
    pos = {"tile - 1": 63, "tile": 64, "split - 1": chunk - 1,
           "split": chunk, "split + tile + 1": chunk + 65,
           "last split only": (nsplit - 1) * chunk + 17}[where]
    q, k, v = _flash_inputs(b, length, kv, g, hd, torch.bfloat16, seed=4)
    got = flash_decode(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                             device="cuda"))
    torch.cuda.synchronize()
    _flash_close(got, flash_decode_ref(q, k, v, pos))


def test_flash_decode_bf16_calls_in_a_row_reset_their_tickets():
    """The last block of each row resets its ticket: back-to-back calls of
    one shape, then of a shape with more rows, then the first again, all
    hold to the plain version."""
    _need_card()
    shapes = [(4, 1000, 8, 4, 128), (8, 300, 8, 2, 128), (4, 1000, 8, 4, 128)]
    for i, (b, length, kv, g, hd) in enumerate(shapes):
        q, k, v = _flash_inputs(b, length, kv, g, hd, torch.bfloat16, seed=i)
        outs = [flash_decode(q, k, v, torch.tensor(p, dtype=torch.int32,
                                                   device="cuda"))
                for p in (length - 1, length // 3, length - 1)]
        torch.cuda.synchronize()
        _flash_close(outs[0], flash_decode_ref(q, k, v, length - 1))
        _flash_close(outs[1], flash_decode_ref(q, k, v, length // 3))
        assert torch.equal(outs[0], outs[2])


def test_flash_decode_bf16_on_two_streams_at_once():
    """Calls queued on two streams, released together so that they run at
    the same time, each take their own tickets: every output holds to the
    plain version.  Calls whose later splits end at once (a small pos)
    alternate with calls that read every split."""
    _need_card()
    b, length, kv, g, hd = 4, 8192, 8, 4, 128
    assert _ring_chunk(b, length, kv, hd)[1] > 2
    q, k, v = _flash_inputs(b, length, kv, g, hd, torch.bfloat16, seed=7)
    positions = [length - 1, 100, length // 2, 1000] * 4
    pos_t = [torch.tensor(p, dtype=torch.int32, device="cuda")
             for p in positions]
    torch.cuda.synchronize()
    gate, streams = torch.cuda.Stream(), [torch.cuda.Stream()
                                          for _ in range(2)]
    with torch.cuda.stream(gate):
        torch.cuda._sleep(50_000_000)         # until every call is queued
    released = gate.record_event()
    for s in streams:
        s.wait_event(released)
    outs = []
    for i, p in enumerate(pos_t):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(flash_decode(q, k, v, p))
    torch.cuda.synchronize()
    for pos, got in zip(positions, outs):
        _flash_close(got, flash_decode_ref(q, k, v, pos))


@pytest.mark.parametrize("kernel", ["embedding_bag_grad_resident",
                                    "flash_decode"])
def test_planned_shared_memory_is_the_kernels(kernel):
    """The wrappers plan with Python copies of the kernels' shared-memory
    sums; the kernels' own sums agree at every size a launch can ask."""
    _need_card()
    from repro_torch.kernels import runtime
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_decode as fd
    lib = runtime.load_library(kernel)
    if kernel == "flash_decode":
        own = lib.repro_flash_decode_ring_smem_bytes
        cases = [((hd, stages), fd.ring_smem_bytes(hd, stages))
                 for hd in fd.HEAD_DIMS
                 for stages in range(fd.MAX_STAGES + 1)]
    else:
        own = lib.repro_embedding_bag_grad_resident_smem_bytes
        cases = [((d, chunk), eb.resident_smem_bytes(d, chunk))
                 for d in range(eb.resident_max_d() + 1)
                 for chunk in (0, 32, eb.RESIDENT_MIN_CHUNK,
                               eb.RESIDENT_MAX_THREADS)]
    assert [own(*args) for args, _ in cases] == [n for _, n in cases]


def test_aggregate_embedding_on_the_card_is_deterministic():
    """``aggregate_embedding`` runs through ``embedding_bag_grad``: one
    launch a call, sums in entry order, so two calls agree bit for bit and
    equal the plain version on a CPU copy."""
    _need_card()
    from repro_torch.core.gba import aggregate_embedding
    gen = torch.Generator().manual_seed(21)
    m, n, d, cap = 16, 512, 16, 300
    args = (torch.randint(-3, cap + 3, (m, n), generator=gen,
                          dtype=torch.int32),
            torch.randn((m, n, d), generator=gen),
            torch.randint(0, 10, (m,), generator=gen, dtype=torch.int32),
            torch.randint(0, 10, (cap,), generator=gen, dtype=torch.int32))
    valid = torch.rand((m, n), generator=gen) > 0.1
    want = aggregate_embedding(*args, 9, 2, cap, valid=valid)
    card = [a.cuda() for a in args]
    launches = embedding_bag_grad.launches
    first = aggregate_embedding(*card, 9, 2, cap, valid=valid.cuda())
    second = aggregate_embedding(*card, 9, 2, cap, valid=valid.cuda())
    torch.cuda.synchronize()
    assert embedding_bag_grad.launches == launches + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.cpu().view(torch.int32), w.view(torch.int32))


def test_switch_driver_on_the_card_matches_the_cpu():
    """The demo driver on the card: every simulated field of the strained
    run equal to the CPU run's, one ``gba_apply`` launch per shard and
    async global step, and the fused replays of a switched schedule bit
    for bit equal to the unswitched ones."""
    _need_card()
    import json
    from repro_torch.launch import switch_driver as SD

    def driver(device, impl="psum"):
        params, loss_fn, group_by = SD.demo_model(device=device)
        return SD.SwitchDriver(
            4, loss_fn, params, spec=SD.demo_spec(4),
            plan=SD.demo_plan("strained", 4),
            cfg=SD.SwitchConfig(local_batch=64, sync_impl=impl),
            batch_fn=SD.demo_batch_fn(64), group_by=group_by)

    def fields(r):
        out = r.to_json()
        out.pop("final_loss")
        return json.dumps(out, sort_keys=True)

    launches = gba_apply.launches
    card = driver("cuda").run(96, mode="auto")
    torch.cuda.synchronize()
    host = driver("cpu").run(96, mode="auto")
    assert fields(card) == fields(host) and card.swaps_verified >= 1
    assert gba_apply.launches - launches == 4 * card.mode_steps["gba"]
    np.testing.assert_allclose(card.losses, host.losses, rtol=1e-5)
    steps = [SD.GlobalStep((k,) * 4, tuple(range(4 * k, 4 * k + 4)))
             for k in range(8)]
    drv = driver("cuda", "fused")
    runs = [drv.run_schedule(steps, modes) for modes in (
        ["sync"] * 3 + ["gba"] * 3 + ["sync"] * 2, ["gba"] * 8,
        ["sync"] * 8)]
    for r in runs[1:]:
        assert np.array_equal(r.param_flat.view(np.int32),
                              runs[0].param_flat.view(np.int32))
        assert np.array_equal(r.accum_flat.view(np.int32),
                              runs[0].accum_flat.view(np.int32))
        assert r.losses == runs[0].losses


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "flat"])
def test_sharded_apply_matches_one_whole_buffer_launch(grouped):
    """The sharded buffer's apply, one ``gba_apply`` launch per each of 4
    shards on its contiguous block, bit-identical to one launch over the
    whole ``(M, padded_total)`` buffer on the card and to the plain
    version on the CPU; the 4 shards are leaves that are not tile
    multiples, so padding columns are in the run."""
    _need_card()
    from repro_torch.core.flat_sharded import (init_sharded_flat_buffer,
                                               sharded_flat_push_and_maybe_apply)
    from repro_torch.convert import tree_to_device
    from repro_torch.distributed import selfcheck
    params = tree_to_device(selfcheck.problem(4)[0], torch.device("cuda"))
    lay, buf = init_sharded_flat_buffer(
        params, 4, 4, tile=256, group_by=(lambda p: p[0]) if grouped
        else None)
    gen = torch.Generator(device="cuda").manual_seed(5)
    whole = torch.randn((4, lay.padded_total), generator=gen, device="cuda")
    p0 = lay.ravel(params)
    a0 = torch.rand(lay.padded_total, generator=gen, device="cuda") + 0.05
    tokens = [3, 3, 0, 3]
    buf["step"] = 3
    p, a = p0.clone(), a0.clone()
    launches = gba_apply.launches
    for j in range(4):
        p, a, applied, buf = sharded_flat_push_and_maybe_apply(
            buf, whole[j], tokens[j], p, a, 0.05, layout=lay, iota=2)
    torch.cuda.synchronize()
    assert applied and gba_apply.launches == launches + 4
    wp, wa = p0.clone(), a0.clone()
    toks = torch.tensor(tokens, dtype=torch.int32, device="cuda")
    gba_apply(wp, wa, whole, toks, 3, 0.05, iota=2)
    hp, ha = gba_apply_ref(p0.cpu(), a0.cpu(), whole.cpu(), toks.cpu(), 3,
                           0.05, iota=2)
    for got, want in ((p, wp), (a, wa), (p.cpu(), hp), (a.cpu(), ha)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_one_rank_nccl_world_is_bit_identical_to_in_process(tmp_path):
    """A small wire step (none, int8, onebit) over a one-rank NCCL world
    holding all 4 workers, bit-identical to the in-process backend on the
    card; the world is destroyed after."""
    _need_card()
    import os
    import torch.distributed as dist
    from repro_torch.distributed import inprocess, process_group, selfcheck
    for d in ("nccl", "in"):
        os.mkdir(tmp_path / d)
    world, dev = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                    "cuda", timeout=120.0)
    try:
        assert world.backend == "nccl"
        launches = gba_apply.launches
        selfcheck.run(world, dev, 4, ("none", "int8", "onebit"),
                      str(tmp_path / "nccl"))
        torch.cuda.synchronize()
        assert gba_apply.launches - launches == 3 * selfcheck.STEPS * 4
    finally:
        process_group.leave()
    assert not dist.is_initialized()
    selfcheck.run(inprocess, torch.device("cuda"), 4,
                  ("none", "int8", "onebit"), str(tmp_path / "in"))
    got = torch.load(tmp_path / "nccl" / "part0.pt")
    want = torch.load(tmp_path / "in" / "part0.pt")
    for scheme, held in want.items():
        assert set(got[scheme]) == set(held)
        for k, v in held.items():
            assert torch.equal(got[scheme][k].view(torch.int32),
                               v.view(torch.int32)), (scheme, k)


@pytest.mark.parametrize("case", ["psum", "switched", "fused", "demo_auto",
                                  "demo_schedule", "demo_nan"])
def test_one_rank_nccl_world_switches_and_shards_as_in_process(tmp_path,
                                                               case):
    """The psum sync step, a switched schedule, the sharded fused step
    and the demo driver's runs over a one-rank NCCL world holding all 4
    workers and shards, bit-identical to the in-process backend on the
    card (the fused losses too: one rank's share is the whole batch's
    mean); a NaN batch commits nothing."""
    _need_card()
    import os
    import torch.distributed as dist
    from repro_torch.distributed import inprocess, process_group, selfcheck
    for d in ("nccl", "in"):
        os.mkdir(tmp_path / d)
    world, dev = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                    "cuda", timeout=120.0)
    try:
        selfcheck.run(world, dev, 4, (case,), str(tmp_path / "nccl"))
    finally:
        process_group.leave()
    assert not dist.is_initialized()
    selfcheck.run(inprocess, torch.device("cuda"), 4, (case,),
                  str(tmp_path / "in"))
    got = torch.load(tmp_path / "nccl" / "part0.pt")[case]
    want = torch.load(tmp_path / "in" / "part0.pt")[case]
    assert set(got) == set(want)
    for k, v in want.items():
        assert selfcheck.differing(got[k], v) == 0, k
    if case == "demo_nan":
        assert all(v.item() == 0 for v in want.values())
