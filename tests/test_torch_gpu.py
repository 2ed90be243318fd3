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
1e-6), f32 outputs within rtol 1e-5, atol 1e-6, at every head dim it
takes (64, 80, 112, 128, 256); under the partial contract
(``flash_decode_partial``) its float32 output and log-sum-exp within
rtol 1e-5, atol 1e-6 and 1e-5 of the plain version's, and its output,
rounded to the inputs' dtype, bit for bit the old contract's wherever
the row holds a position.
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
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_partial)
from repro_torch.kernels.fused_adagrad import fused_adagrad
from repro_torch.kernels.gba_aggregate import gba_aggregate
from repro_torch.kernels.gba_apply import gba_apply
from repro_torch.kernels.quantize import (dequantize, quantize_minmax,
                                          quantize_sign)
from repro_torch.kernels.ref import (dequantize_ref, embedding_bag_grad_ref,
                                     embedding_bag_ref,
                                     flash_decode_partial_ref,
                                     flash_decode_ref,
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


# kimi-k2's head dim: 112 is a multiple of 16 but not of 32 or 64
HD112_LENGTHS = (1, 63, 700, 32_768)


@pytest.mark.parametrize("where", ["last slot", "mid-cache"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("length", HD112_LENGTHS)
@pytest.mark.parametrize("g", [1, 4, 8])
def test_flash_decode_at_head_dim_112(g, length, dtype, where):
    """hd 112 on both paths (the bf16 ring's second box half past the row,
    the f32 path's idle lanes), held to the plain version."""
    _need_card()
    b, kv = 2, 8
    q, k, v = _flash_inputs(b, length, kv, g, 112, dtype, seed=g + length)
    pos = length - 1 if where == "last slot" else length // 2
    launches = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                             device="cuda"))
    torch.cuda.synchronize()
    assert flash_decode.launches == launches + 1
    assert got.dtype == dtype and got.shape == (b, kv, g, 112)
    _flash_close(got, flash_decode_ref(q, k, v, pos))


# zamba2's shared attention: hd 80 (a multiple of 16, not of 32), 32 KV
# heads, G 1
HD80_LENGTHS = (1, 63, 160, 700, 32_768)


@pytest.mark.parametrize("where", ["last slot", "mid-cache"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("length", HD80_LENGTHS)
@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_at_head_dim_80(g, length, dtype, where):
    """hd 80 on both paths (the bf16 ring's second box 48 columns past the
    row, the f32 path's 128 threads of 4 values a lane, lanes 20-31
    idle), held to the plain version, at zamba2's 32 KV heads."""
    _need_card()
    b, kv = 2, 32
    q, k, v = _flash_inputs(b, length, kv, g, 80, dtype, seed=g + length)
    pos = length - 1 if where == "last slot" else length // 2
    launches = flash_decode.launches
    got = flash_decode(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                             device="cuda"))
    torch.cuda.synchronize()
    assert flash_decode.launches == launches + 1
    assert got.dtype == dtype and got.shape == (b, kv, g, 80)
    _flash_close(got, flash_decode_ref(q, k, v, pos))


# the launch shapes (B, L, KV, G, hd) of the cross layers' archs:
# llama-3.2-vision-11b's cross-attention over 1,601 image tokens (not a
# multiple of the ring's 64-position tile), seamless-m4t-medium's hd 64 at
# G 1 over 16 KV heads, its self-attention and its cross-attention over
# 1,024 encoder frames
CROSS_SHAPES = {
    "llama cross (4, 1601, 8, 4, 128)": (4, 1601, 8, 4, 128),
    "seamless self (4, 160, 16, 1, 64)": (4, 160, 16, 1, 64),
    "seamless cross (4, 1024, 16, 1, 64)": (4, 1024, 16, 1, 64),
}


@pytest.mark.parametrize("where", ["last slot", "mid-cache"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CROSS_SHAPES))
def test_flash_decode_at_the_cross_archs_shapes(case, dtype, where):
    """The cross archs' shapes on both paths, held to the plain version;
    the cross-attention's own position is the last slot (L - 1), which
    masks nothing."""
    _need_card()
    b, length, kv, g, hd = CROSS_SHAPES[case]
    q, k, v = _flash_inputs(b, length, kv, g, hd, dtype, seed=length + g)
    pos = length - 1 if where == "last slot" else length // 2
    launches = flash_decode.launches
    got = flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode.launches == launches + 1
    assert got.dtype == dtype and got.shape == (b, kv, g, hd)
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


# (B, L, KV, G, hd): one split and many on each path, at the head dims of
# the sequence-split decode (zamba2-2.7b 80, granite-8b 128, gemma3-12b
# 256; its (4, 1) slice of long_500k is 131,072 positions)
PARTIAL_CASES = {
    "hd 80, one split": (1, 160, 32, 1, 80),
    "hd 80, many splits": (1, 32_768, 32, 1, 80),
    "hd 128, one split": (2, 160, 8, 4, 128),
    "hd 128, many splits": (2, 8192, 8, 4, 128),
    "hd 256, one split": (1, 192, 8, 2, 256),
    "hd 256, many splits": (1, 131_072, 8, 2, 256),
}
PARTIAL_START = 1000     # the slice's first position in the whole sequence


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("where", ["before", "inside", "past"])
@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_flash_decode_partial_matches_plain_version(case, where, dtype):
    """The partial contract at a position before the slice (every row
    empty: out 0, lse -inf), inside it and past it: the float32 out and
    lse within float32 rounding of the plain version's; out rounded to
    the inputs' dtype bit for bit the old contract's output at the local
    position wherever the row holds a position; one launch a call."""
    _need_card()
    b, length, kv, g, hd = PARTIAL_CASES[case]
    q, k, v = _flash_inputs(b, length, kv, g, hd, dtype, seed=length + hd)
    pos = {"before": PARTIAL_START - 5,
           "inside": PARTIAL_START + length // 2,
           "past": PARTIAL_START + length + 100}[where]
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    launches = flash_decode.launches
    out, lse = flash_decode_partial(q, k, v, pos_t, PARTIAL_START)
    torch.cuda.synchronize()
    assert flash_decode.launches == launches + 1
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == (b, kv, g)
    want_out, want_lse = flash_decode_partial_ref(q, k, v, pos,
                                                  PARTIAL_START)
    if where == "before":
        assert not out.any() and bool((lse == -float("inf")).all())
        return
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    old = flash_decode(q, k, v, torch.tensor(pos - PARTIAL_START,
                                             dtype=torch.int32,
                                             device="cuda"))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.to(dtype).view(bits), old.view(bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_decode_partials_combine_to_the_whole_call(dtype):
    """gemma3-12b's global layer cut in 4 slices (its (4, 1) decode), the
    position in the third: the float32 partials weighed by their lse and
    rounded once are the whole plain call within ``flash_decode``'s
    tolerance."""
    _need_card()
    b, length, kv, g, hd = 1, 4 * 4096, 8, 2, 256
    q, k, v = _flash_inputs(b, length, kv, g, hd, dtype, seed=9)
    pos = torch.tensor(2 * 4096 + 77, dtype=torch.int32, device="cuda")
    n = length // 4
    parts = [flash_decode_partial(q, k[:, s * n:(s + 1) * n].contiguous(),
                                  v[:, s * n:(s + 1) * n].contiguous(), pos,
                                  s * n) for s in range(4)]
    assert not parts[3][0].any()
    lse = torch.stack([x for _, x in parts])
    w = torch.exp(lse - lse.amax(dim=0))
    got = sum(wi[..., None] * o for wi, (o, _) in zip(w, parts)) \
        / w.sum(dim=0)[..., None]
    _flash_close(got.to(dtype), flash_decode_ref(q, k, v, int(pos)))


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-2.7b"])
def test_sequence_split_decode_card_vs_cpu(arch):
    """``build_step``'s batch-1 decode over (2, 2), its KV sequences split
    over ``data``, ``.reduced()`` in float32 on the card (each global
    layer through ``flash_decode_partial``, one launch a (data, model)
    shard) against the same on the CPU: next tokens equal, logits within
    1e-5 of the largest."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 31),
                         generator=torch.Generator().manual_seed(4))
    _, cache = T.prefill(params, cfg, toks, cache_len=64)
    runs = {}
    for dev in ("cpu", "cuda"):
        dec, _ = steps.build_step(cfg, InputShape("d1", 64, 1, "decode"),
                                  Mesh(("data", "model"), (2, 2)))
        caches = dec.place_cache(T._map(cache, lambda x: x.to(dev)))
        held = dec.place_params(T._map(params, lambda x: x.to(dev)))
        tok, out = toks[:, -1:].to(torch.int32).to(dev), []
        launches = flash_decode.launches
        for _ in range(3):
            tok, logits, caches = dec(held, tok, caches)
            out.append((tok.cpu(), logits.cpu()))
        if dev == "cuda":
            globals_ = sum(k == "global" for k in cfg.block_pattern) \
                if arch == "gemma3-12b" else 1
            assert flash_decode.launches - launches == 3 * 4 * globals_
        runs[dev] = out
    for (tc, lc), (tg, lg) in zip(runs["cpu"], runs["cuda"]):
        assert torch.equal(tc, tg)
        assert (lg - lc).abs().max() <= 1e-5 * lc.abs().max()


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


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b", "starcoder2-3b",
                                  "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_full_width_layers_decode_through_their_route(arch):
    """Each new layer kind at full width (the arch's prefix and one repeat
    of its pattern, bf16): 6 decode steps at a scalar position, each
    global layer without a softcap through ``flash_decode``, against the
    same steps at a (B,) vector of that position (every layer through the
    masked attention), both fed the scalar run's tokens: logits within
    2**-6 of the largest, and ``flash_decode`` launched once a step for
    each global layer without a softcap.  The two routes' attention
    outputs may round one bf16 ulp apart, which can move a top-k choice
    among kimi-k2's 384 experts (and at a capacity of 1 a decode step,
    which entries are dropped), so the masked run replays the kernel
    run's expert choices and slots, its weights renormalised from its own
    router probabilities: what is compared is the attention route."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = dataclasses.replace(
        full, num_layers=len(full.prefix_layers) + len(full.block_pattern))
    params = T.init_model(cfg, generator=torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 72), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    kernel_layers = 0 if cfg.attn_softcap else sum(
        kind == "moe" or kind == "global"
        for kind in (*cfg.prefix_layers, *cfg.block_pattern))

    def run(vector, tokens=None):
        logits, cache = T.prefill(params, cfg, prompts, cache_len=80)
        if vector:
            cache["pos"] = cache["pos"].expand(2).clone()
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out, seen = [tok], []
        for i in range(6):
            lg, cache = T.decode_step(params, cfg, tok if tokens is None
                                      else tokens[:, i:i + 1], cache)
            seen.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, 1), torch.cat(seen, 1)

    routed, route = [], L.moe_route

    def record(p, cfg, xt):
        r = route(p, cfg, xt)
        routed.append(r)
        return r

    def replay(p, cfg, xt):
        r, want = route(p, cfg, xt), routed.pop(0)
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        w = probs.gather(1, want["sel"])
        return {**r, "sel": want["sel"], "slot": want["slot"],
                "keep": want["keep"], "weights": w / w.sum(-1, keepdim=True)}

    launches = flash_decode.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "moe_route", record)
        tokens, logits = run(False)
    assert flash_decode.launches == launches + 6 * kernel_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "moe_route", replay)
        _, masked = run(True, tokens)
    assert not routed
    assert flash_decode.launches == launches + 6 * kernel_layers
    assert bool(torch.isfinite(logits).all())
    err = (logits - masked).abs().max().item()
    assert err <= 2.0**-6 * masked.abs().max().item(), err
    del params
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_full_width_ssm_layers_decode_through_their_route(arch):
    """One repeat of each Mamba2 arch's pattern at full width, bf16 (1
    mixer layer of mamba2-780m; 5 mixer layers and one mixer with the
    shared attention at hd 80 of zamba2-2.7b): 6 decode steps at a scalar
    position (the shared attention through ``flash_decode``, one launch a
    step) against the same steps at a (B,) vector of that position (the
    masked attention), both fed the scalar run's tokens: logits within
    2**-6 of the largest.  mamba2 launches no kernel."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=len(full.block_pattern))
    params = T.init_model(
        cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (2, 72), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    kernel_layers = sum(k == "mamba_attn" for k in cfg.block_pattern)

    def run(vector, tokens=None):
        logits, cache = T.prefill(params, cfg, prompts, cache_len=80)
        if vector:
            cache["pos"] = cache["pos"].expand(2).clone()
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out, seen = [tok], []
        for i in range(6):
            lg, cache = T.decode_step(params, cfg, tok if tokens is None
                                      else tokens[:, i:i + 1], cache)
            seen.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, 1), torch.cat(seen, 1)

    launches = flash_decode.launches
    tokens, logits = run(False)
    assert flash_decode.launches == launches + 6 * kernel_layers
    _, masked = run(True, tokens)
    assert flash_decode.launches == launches + 6 * kernel_layers
    assert bool(torch.isfinite(logits).all())
    err = (logits - masked).abs().max().item()
    assert err <= 2.0**-6 * masked.abs().max().item(), err
    del params
    torch.cuda.empty_cache()


def test_full_width_moe_layer_trains_on_the_card_as_on_the_cpu():
    """phi3.5-moe's MoE FFN at full width (d_model 4096, 16 experts of
    d_ff 6400, top 2) in float32, forward and backward on the card
    against the CPU from the same draw: 128 tokens, some past their
    expert's capacity of 20.  The router's seed (1) leaves every token's
    2nd and 3rd probability 7.1e-4 apart or more on the CPU, so both sides
    choose alike: ``sel``, ``slot`` and ``keep`` are held equal first.
    Then the output, the aux loss and the gradients of the input and of
    every leaf of ``loss = sum(y * dy) + aux`` within 1e-5 of each one's
    largest magnitude (float32 sums in other orders; the dispatch's
    ``index_put_`` and the gather's backward add with atomics on the
    card)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              dtype="float32")
    host = T._materialize(L.moe_spec(cfg), torch.Generator().manual_seed(1),
                          torch.device("cpu"))
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(101))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_() for k, v in host.items()}
        xin = x.to(dev).requires_grad_()
        routes, route = [], L.moe_route

        def record(p, cfg, xt):
            routes.append(route(p, cfg, xt))
            return routes[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(L, "moe_route", record)
            y, aux = L.moe_fwd(p, cfg, xin)
        loss = (y * dy.to(dev)).sum() + aux
        grads = torch.autograd.grad(loss, [xin, *p.values()])
        runs[dev] = (routes[0], y.detach().cpu(), aux.item(),
                     [g.cpu() for g in grads])
        del p, xin, y, grads
    (rc, yc, ac, gc), (rg, yg, ag, gg) = runs["cpu"], runs["cuda"]
    dropped = int((~rc["keep"]).sum())
    assert rc["cap"] == rg["cap"] == 20 and dropped > 0
    for k in ("sel", "slot", "keep"):
        assert torch.equal(rg[k].cpu(), rc[k]), k
    assert (yg - yc).abs().max() <= 1e-5 * yc.abs().max()
    assert abs(ag - ac) <= 1e-5 * abs(ac)
    for name, a, b in zip(["x", *host], gg, gc):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
    torch.cuda.empty_cache()


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
        assert 80 in fd.HEAD_DIMS
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


def _memory_batch(cfg, seed, seq=16):
    """One sequence of ``seq`` tokens and labels and a drawn memory
    (``image_embeds``, or ``frames`` for the encoder) on the host."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), generator=gen)
    key, length = (("image_embeds", cfg.num_image_tokens)
                   if cfg.family == "vlm" else ("frames", cfg.encoder_frames))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            key: torch.randn((1, length, cfg.d_model), generator=gen)}


@pytest.mark.parametrize("arch,layers", [("llama-3.2-vision-11b", 5),
                                         ("seamless-m4t-medium", 1)])
def test_full_width_cross_stack_trains_on_the_card_as_on_the_cpu(arch,
                                                                 layers):
    """One full-width repeat of llama-3.2-vision-11b (4 global layers and a
    cross layer over 1,601 drawn image embeddings) and seamless-m4t-medium's
    full encoder (12 layers over 1,024 drawn frames) and one cross layer,
    in float32: ``lm_loss`` over the memory and every gradient leaf, the
    cross layer's ``xattn`` and the encoder's included, card against CPU
    from the same draw, within 1e-5 of each one's largest magnitude
    (float32 sums in other orders)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.core.gba import tree_paths
    from repro_torch.launch.programs import loss_and_grads
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=layers)
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    batch = _memory_batch(cfg, 4)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = host if dev == "cpu" else T._map(host, lambda t: t.cuda())
        loss, grads = loss_and_grads(
            cfg, params, {k: v.to(dev) for k, v in batch.items()})
        runs[dev] = (loss.item(), [(p, g.cpu()) for p, g in
                                   tree_paths(grads)])
        del params, grads
        torch.cuda.empty_cache()
    (lc, gc), (lh, gh) = runs["cuda"], runs["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    names = {p[0] for p, _ in gh} | {p[2] for p, _ in gh
                                     if p[0] == "blocks"}
    assert "xattn" in names and ("encoder" in names) == (layers == 1)
    for (path, a), (_, b) in zip(gc, gh):
        assert bool(torch.isfinite(a).all()), path
        assert b.abs().max() > 0, f"{path}: a zero gradient"
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), path


def test_full_opt_layer_at_2048_tokens_matches_the_baseline_on_the_card():
    """granite-8b's full-width layer (bf16) over one sequence of 2,048
    tokens under ``full_opt`` (queries in chunks of 1,024 and the loss in
    chunks of 512, each checkpointed, the repeat checkpointed) against the
    baseline on the card: the loss within 2**-6 relative, each gradient
    leaf within 2**-5 of its largest magnitude (bf16 intermediates rounded
    in other groupings), and a lower peak of device memory."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.core.gba import tree_paths
    from repro_torch.launch.programs import loss_and_grads
    from repro_torch.launch.variants import VARIANTS
    from repro_torch.models import transformer as T
    base = dataclasses.replace(get_config("granite-8b"), num_layers=1)
    params = T.init_model(base, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    toks = torch.randint(0, base.vocab_size, (1, 2049), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for name in ("baseline", "full_opt"):
        cfg, _ = VARIANTS[name](base, {})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
        runs[name] = (loss.item(), [g for _, g in tree_paths(grads)],
                      torch.cuda.max_memory_allocated())
    (lb, gb, pb), (lo, go, po) = runs["baseline"], runs["full_opt"]
    assert abs(lo - lb) <= 2.0**-6 * abs(lb)
    for a, b in zip(go, gb):
        assert (a.float() - b.float()).abs().max() \
            <= 2.0**-5 * b.float().abs().max()
    assert po < pb, (po, pb)
    del params, runs
    torch.cuda.empty_cache()


def _reduced_f32(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _mesh_2x2_run(cfg, host, dev, world=None, model=2, workers=2,
                  place_state=False):
    """8 microsteps of ``--fused --mesh 2x2`` (``workers x model``) at M =
    4, microstep 5's slot stale, from ``host`` params on ``dev``, the
    weights whole over ``data`` unless ``place_state`` (FSDP): the losses,
    each model shard's raveled params (gathered over ``data``) and the
    accumulator, on the host."""
    from repro_torch.configs import GBAConfig
    from repro_torch.convert import tree_to_device
    from repro_torch.data import make_lm_stream
    from repro_torch.distributed import inprocess
    from repro_torch.launch.programs import build_programs
    gba = GBAConfig(local_batch=2, buffer_size=4, staleness_tolerance=4)
    progs = build_programs(cfg, gba, params=tree_to_device(
        host, torch.device(dev)), mode="fused", lr=1e-3, workers=workers,
        model=model, world=world or inprocess, place_state=place_state)
    stream = make_lm_stream(cfg.vocab_size, 80, 2, seed=0)
    state, losses = progs.state, []
    for i, token in enumerate([0, 0, 0, 0, 1, -5, 1, 1]):
        state, loss = progs.step(state, {
            k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch(i).items()}, token)
        losses.append(loss.item())
    trees = progs.gather_params(state["params"])
    return (losses, torch.cat([progs.layout.ravel(p).cpu() for p in (
        trees if isinstance(trees, list) else [trees])]),
            state["accum"].cpu())


def _mesh_card_vs_cpu(arch, model, rtol=1e-5):
    _need_card()
    from repro_torch.models import transformer as T
    cfg = _reduced_f32(arch)
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    launches = gba_apply.launches
    lc, pc, ac = _mesh_2x2_run(cfg, host, "cuda", model=model)
    assert gba_apply.launches - launches == 2 * 2 * model
    lh, ph, ah = _mesh_2x2_run(cfg, host, "cpu", model=model)
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    assert torch.allclose(pc, ph, rtol=rtol, atol=1e-7)
    assert torch.allclose(ac, ah, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("arch", ["granite-8b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-780m", "zamba2-2.7b"])
def test_mesh_2x2_fused_step_on_the_card_matches_the_cpu(arch):
    """``--fused --mesh 2x2`` (2 data x 2 model shards in process) at
    ``.reduced()`` float32, card against CPU from the same params (seed
    3): losses within rtol 1e-5, every model shard's params and the
    accumulator within rtol 1e-5 / atol 1e-7 (float32 sums in other
    orders; zamba2's 6-layer stack within rtol 1e-4, as phase 19 holds
    it); 4 ``gba_apply`` launches an apply on the card."""
    _mesh_card_vs_cpu(arch, 2, 1e-4 if arch == "zamba2-2.7b" else 1e-5)


@pytest.mark.parametrize("arch,model", [("starcoder2-3b", 4),
                                        ("granite-8b", 8)])
def test_head_dim_fallback_fused_step_on_the_card_matches_the_cpu(arch,
                                                                  model):
    """The rules' head_dim fallback on the card against the CPU, as
    above: starcoder2's 2 KV heads along head_dim at 2 x 4, every
    projection along head_dim at 2 x 8; 2 x ``model`` launches an
    apply."""
    _mesh_card_vs_cpu(arch, model)


def test_one_rank_nccl_world_holding_the_2x2_shards_is_in_process(tmp_path):
    """The same step over a one-rank NCCL world holding both model and
    both data shards is the in-process step on the card bit for bit."""
    _need_card()
    import torch.distributed as dist
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cuda", timeout=120.0)
    try:
        got = _mesh_2x2_run(cfg, host, "cuda", world)
    finally:
        process_group.leave()
    assert not dist.is_initialized()
    want = _mesh_2x2_run(cfg, host, "cuda")
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _same_run(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("workers,model", [(2, 2), (4, 1)])
def test_fsdp_step_on_the_card_is_the_unplaced_step(workers, model):
    """FSDP of the weights over ``data`` (``place_state=True``) on the
    card, granite-8b ``.reduced()`` float32 over 2 x 2 and 4 x 1 in
    process: losses, params and accumulator bit for bit the same step
    with the weights whole over ``data``; W x T ``gba_apply`` launches an
    apply."""
    _need_card()
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    launches = gba_apply.launches
    got = _mesh_2x2_run(cfg, host, "cuda", model=model, workers=workers,
                        place_state=True)
    assert gba_apply.launches - launches == 2 * workers * model
    _same_run(got, _mesh_2x2_run(cfg, host, "cuda", model=model,
                                 workers=workers))


def test_fsdp_over_a_one_rank_nccl_world_is_in_process(tmp_path):
    """The FSDP step over a one-rank NCCL world holding both model and
    both data shards is the in-process FSDP step on the card bit for
    bit."""
    _need_card()
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cuda", timeout=120.0)
    try:
        got = _mesh_2x2_run(cfg, host, "cuda", world, place_state=True)
    finally:
        process_group.leave()
    _same_run(got, _mesh_2x2_run(cfg, host, "cuda", place_state=True))


def _placed_serve(cfg, host, device, mesh, serve_tp=False, world=None,
                  steps=4):
    """``launch.steps.build_step``'s prefill of 4 x 16 tokens into a
    cache of 24 and ``steps`` greedy decode steps over ``mesh`` on
    ``device``: the logits of each, the tokens, the cache leaves (host)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import inprocess
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import tree_map
    from repro_torch.launch.dryrun import CARD_BYTES
    m = Mesh(("data", "model"), mesh)
    kw = dict(serve_tp=serve_tp, world=world or inprocess,
              hbm_budget=CARD_BYTES)
    pre, _ = St.build_step(cfg, InputShape("p", 16, 4, "prefill"), m,
                           cache_len=24, **kw)
    dec, _ = St.build_step(cfg, InputShape("d", 24, 4, "decode"), m, **kw)
    held = pre.place_params(tree_map(lambda t: t.to(device), host))
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(5))
    logits, caches = pre(held, pre.place_batch({"tokens": toks.to(device)}))
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out, tokens = [logits[:, None].cpu()], [tok.cpu()]
    for _ in range(steps):
        tok, lg, caches = dec(held, tok, caches)
        out.append(lg.cpu())
        tokens.append(tok.cpu())
    from repro_torch.core.gba import tree_paths
    return (torch.cat(out, 1), torch.cat(tokens, 1),
            [x.cpu() for c in caches for _, x in tree_paths(c)])


@pytest.mark.parametrize("mesh,serve_tp", [((1, 4), True), ((2, 2), False)])
def test_placed_serve_on_the_card_matches_the_cpu(mesh, serve_tp):
    """``build_step``'s placed prefill and 4 decode steps, granite-8b
    ``.reduced()`` float32, over 1 x 4 by ``serve_param_specs`` and 2 x 2
    by ``param_specs`` (each weight gathered over ``data``), card against
    CPU: logits within rtol 1e-5 / atol 1e-5 of the largest, tokens and
    every cache slice likewise; on the card each decode step launches
    ``flash_decode`` once a layer a held model shard."""
    _need_card()
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    launches = flash_decode.launches
    lc, tc, cc = _placed_serve(cfg, host, "cuda", mesh, serve_tp)
    assert flash_decode.launches - launches == \
        4 * cfg.num_layers * mesh[1]
    lh, th, ch = _placed_serve(cfg, host, "cpu", mesh, serve_tp)
    scale = lh.abs().max()
    assert torch.allclose(lc, lh, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(tc, th)
    for a, b in zip(cc, ch):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-5)


def test_placed_serve_over_a_one_rank_nccl_world_is_in_process(tmp_path):
    """The 2 x 2 placed serve over a one-rank NCCL world is the in-process
    run on the card bit for bit: logits, tokens, every cache slice."""
    _need_card()
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cuda", timeout=120.0)
    try:
        got = _placed_serve(cfg, host, "cuda", (2, 2), world=world)
    finally:
        process_group.leave()
    want = _placed_serve(cfg, host, "cuda", (2, 2))
    assert torch.equal(got[1], want[1])
    for a, b in zip([got[0], *got[2]], [want[0], *want[2]]):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def _placed_train(cfg, host, device, world=None):
    """``build_step``'s placed pytree step (Adam) over 2 x 2 at M = 2,
    4 microsteps of 4 x 16 tokens: the losses and the whole params (host)."""
    from repro_torch.configs.base import GBAConfig, InputShape
    from repro_torch.distributed import inprocess
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import tree_map
    from repro_torch.core.gba import tree_paths
    step, _ = St.build_step(cfg, InputShape("t", 16, 4, "train"),
                            Mesh(("data", "model"), (2, 2)),
                            GBAConfig(local_batch=4, buffer_size=2),
                            world=world or inprocess)
    state = step.init_state(tree_map(lambda t: t.to(device), host))
    gen = torch.Generator().manual_seed(6)
    losses = []
    for i in range(4):
        b = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
             .to(device) for k in ("tokens", "labels")}
        state, loss = step(state, step.place_batch(b), i // 2)
        losses.append(loss.item())
    return losses, [x.cpu() for _, x in tree_paths(
        step.gather_params(state["params"]))]


def test_placed_pytree_step_on_the_card_matches_the_cpu(tmp_path):
    """The placed pytree step over 2 x 2, granite-8b ``.reduced()``
    float32, card against CPU: losses within rtol 1e-5; the params after
    two applies within Adam's step where a rounding flips it (lr either
    side) and within rtol 1e-5 / atol 1e-7 at 99.9 % of the elements;
    then over a one-rank NCCL world bit for bit the in-process run."""
    _need_card()
    from repro_torch.distributed import process_group
    from repro_torch.models import transformer as T
    cfg = _reduced_f32("granite-8b")
    host = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    lc, pc = _placed_train(cfg, host, "cuda")
    lh, ph = _placed_train(cfg, host, "cpu")
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    close = total = 0
    for a, b in zip(pc, ph):
        assert (a - b).abs().max() <= 2 * 2e-3
        close += int(torch.isclose(a, b, rtol=1e-5, atol=1e-7).sum())
        total += a.numel()
    assert close >= 0.999 * total
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cuda", timeout=120.0)
    try:
        got = _placed_train(cfg, host, "cuda", world)
    finally:
        process_group.leave()
    assert got[0] == lc
    for a, b in zip(got[1], pc):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# the static auditor's card side (repro_torch.analysis runs on the CPU and
# sees the plain versions only)

AUDIT_TOKENS = (9, 4, 9, 9)          # slot 1 at token = step - iota - 1


def _fills(run, slot):
    """``run()``'s outputs with the tombstone ``slot`` filled with a huge
    finite value and with zeros, and with a fresh slot changed."""
    slot.fill_(torch.tensor(1e30).to(slot.dtype))
    huge = run()
    slot.zero_()
    zero = run()
    moved = run(fresh=True)
    return huge, zero, moved


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("kernel", ["gba_apply", "sharded_apply",
                                    "gba_aggregate"])
def test_flow_002_tombstone_weight_is_exactly_zero_on_the_card(kernel):
    """GBA-FLOW-002 on the CUDA kernels: the tombstone slot's contents
    never reach the outputs, a fresh slot's do."""
    _need_card()
    from repro_torch.core.flat_sharded import (ShardedFlatLayout,
                                               make_sharded_apply)
    gen = torch.Generator(device="cuda").manual_seed(25)
    tokens = torch.tensor(AUDIT_TOKENS, dtype=torch.int32, device="cuda")
    m, n = len(AUDIT_TOKENS), 3 * 8192 + 77
    layout = ShardedFlatLayout.from_params(
        {"w": torch.empty((n,), device="meta")}, 4)
    ss = layout.shard_size
    p0 = torch.randn((4 * ss,), generator=gen, device="cuda")
    a0 = torch.rand((4 * ss,), generator=gen, device="cuda") + 0.1
    shards = torch.randn((4, m, ss), generator=gen, device="cuda",
                         dtype=(torch.bfloat16 if kernel == "gba_aggregate"
                                else torch.float32))
    apply_shards = make_sharded_apply(layout, iota=4)
    # the slots of every shard (sharded apply), else of shard 0's block
    slots = shards.transpose(0, 1) if kernel == "sharded_apply" \
        else shards[0]

    def run(fresh=False):
        if fresh:
            slots[0].mul_(2.0)
        if kernel == "gba_aggregate":
            return (gba_aggregate(shards[0], tokens, 9, iota=4),)
        p, a = p0.clone(), a0.clone()
        if kernel == "sharded_apply":
            apply_shards(p, a, shards.unbind(0), tokens, 9, 1e-3)
        else:
            gba_apply(p[:ss], a[:ss], shards[0], tokens, 9, 1e-3, iota=4)
        return p, a

    huge, zero, moved = _fills(run, slots[1])
    for a, b, c in zip(huge, zero, moved):
        assert torch.equal(_bits(a), _bits(b))
        assert not torch.equal(_bits(b), _bits(c))


def test_coll_001_schedule_on_the_card_and_one_nccl_rank(tmp_path):
    """GBA-COLL-001/002: the fused psum step's recorded schedule on the
    card, in process and over one NCCL rank, is the layout's, and the
    two runs are bit-identical."""
    _need_card()
    from repro_torch.analysis import audit as AU
    from repro_torch.analysis import census as CS
    from repro_torch.configs import get_config
    from repro_torch.core.gba_shard_map import make_gba_fused_psum_step
    from repro_torch.distributed import inprocess, process_group
    from repro_torch.launch.programs import make_loss_fn
    from repro_torch.models import transformer as T
    cfg = get_config("granite-8b").reduced()
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cuda")
    layout = AU.arch_layout(cfg, params, 4)
    batch = {k: v.cuda() for k, v in
             AU.train_batch(cfg, 4, torch.Generator().manual_seed(4)).items()}
    tokens = torch.tensor(AUDIT_TOKENS, dtype=torch.int32, device="cuda")

    def run(world):
        rec = CS.RecordingWorld(world)
        step = make_gba_fused_psum_step(4, make_loss_fn(cfg), layout,
                                        iota=4, lr=1e-3, world=rec)
        pf = layout.ravel(params)
        out = step(pf, torch.full_like(pf, 0.1), batch, tokens, 9)
        assert CS.check_fused_psum_schedule(rec.calls, layout, 4, "t") == []
        return rec.calls, out

    calls, want = run(inprocess)
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cuda", timeout=120.0)
    try:
        got_calls, got = run(world)
    finally:
        process_group.leave()
    assert got_calls == calls
    assert torch.equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_coll_003_dtype_002_decode_on_the_card():
    """GBA-COLL-003 and GBA-DTYPE-002: a decode step on the card issues no
    collective and makes no float64 value outside the kernels."""
    _need_card()
    from repro_torch.analysis import census as CS
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("granite-8b").reduced()
    params = T.init_model(cfg, generator=torch.Generator().manual_seed(3),
                          device="cuda")
    cache = T.init_cache(cfg, 2, 64, "cuda")
    cache["pos"] = torch.tensor(31, dtype=torch.int32, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, 1), dtype=torch.int32,
                        device="cuda")
    before = flash_decode.launches
    with CS.CensusMode() as mode:
        logits, _ = T.decode_step(params, cfg, tok, cache)
    assert mode.collectives == [] and mode.f64 == []
    assert flash_decode.launches > before
    assert bool(torch.isfinite(logits).all())


def _serving_columns(rows):
    """name -> {column: value} of each row, the host latencies left out."""
    out = {}
    for row in rows:
        name, _, derived = row.split(",", 2)
        out[name] = {k: v for k, v in (kv.split("=")
                                       for kv in derived.split(";"))
                     if not k.startswith(("p50_", "p99_"))}
    return out


def test_tab52_serving_rows_on_the_card_match_the_cpu():
    """``run_serving`` at V = 1M: every column but the latencies equal on
    both devices; every lookup call launches the kernel, so the all-hit
    probe (no call) launches nothing."""
    _need_card()
    from repro_torch.benchmarks import tab52_qps
    calls, launches = ops.kernel_calls["pooled_lookup"], embedding_bag.launches
    card = tab52_qps.run_serving(device="cuda")
    calls = ops.kernel_calls["pooled_lookup"] - calls
    launches = embedding_bag.launches - launches
    assert launches > 0 and launches == calls
    got = _serving_columns(card)
    assert got == _serving_columns(tab52_qps.run_serving(device="cpu"))
    assert got["tab52.serving.hot_cache"]["audit_hit_skips_kernel"] == "1"
    assert got["tab52.serving.live_sync"]["versions"] == "9"


def test_checkpoint_manager_restores_onto_the_card(tmp_path):
    _need_card()
    from repro_torch.checkpoint.manager import CheckpointManager
    gen = torch.Generator(device="cuda").manual_seed(7)
    states = [{"params": {"w": torch.randn(64, 8, generator=gen,
                                           device="cuda"),
                          "h": torch.randn(5, 3, generator=gen, device="cuda"
                                           ).to(torch.bfloat16)},
               "opt": {"count": torch.tensor(k, dtype=torch.int32,
                                             device="cuda")},
               "last_update": torch.full((11,), k, dtype=torch.int32,
                                         device="cuda")}
              for k in range(3)]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for k, state in enumerate(states):
        mgr.save(k, state)
    assert mgr.steps() == [1, 2]
    step, got = mgr.restore_latest()
    assert step == 2
    for a, b in zip(_flat(got), _flat(states[2])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert a.shape == b.shape and torch.equal(a, b)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_adam_schedule_and_clip_on_the_card_match_the_cpu():
    """``adam(weight_decay=)`` with a ``warmup_cosine`` override whose step
    is a tensor on the card, after ``clip_by_global_norm``: within rtol
    1e-5, atol 1e-7 of the CPU (the norm's float32 sums in another
    order)."""
    _need_card()
    from repro_torch.optim import clip_by_global_norm, get_optimizer
    from repro_torch.optim import schedules
    sched = schedules.warmup_cosine(1e-3, 2, 10)
    gen = torch.Generator().manual_seed(5)
    host = {"w": torch.randn(256, 64, generator=gen),
            "b": torch.randn(64, generator=gen)}
    card = {k: v.cuda() for k, v in host.items()}
    opt = get_optimizer("adam", 1e-3, weight_decay=0.01)
    hs, cs = opt.init(host), opt.init(card)
    for step in range(1, 4):
        g = {k: torch.randn(v.shape, generator=gen) for k, v in host.items()}
        hg, hn = clip_by_global_norm(g, 1.0)
        cg, cn = clip_by_global_norm({k: v.cuda() for k, v in g.items()},
                                     1.0)
        lr = sched(torch.tensor(step, device="cuda"))
        assert lr.device.type == "cuda"
        host, hs = opt.update(host, hg, hs, lr_override=sched(step))
        card, cs = opt.update(card, cg, cs, lr_override=lr)
        assert cn.item() == pytest.approx(hn.item(), rel=1e-5)
    for a, b in zip(_flat({"p": card, "m": cs["m"], "v": cs["v"]}),
                    _flat({"p": host, "m": hs["m"], "v": hs["v"]})):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the kernels' launch metas against the launches the profiler records
# (kernels/launch_record.py): grid, block and shared memory as the meta
# says, registers within an SM's, no launch rule finding under the card's
# limits; and the card's limits equal to launch_meta.HOPPER
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compiled():
    _need_card()
    from repro_torch.kernels import launch_record, runtime
    runtime.build()
    return launch_record.compiled_kernels(runtime.build_log())


def test_hopper_is_the_cards_limits():
    _need_card()
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.launch_meta import HOPPER
    from repro_torch.kernels.launch_record import device_limits
    limits = device_limits(0)
    assert limits == HOPPER
    sms, smem = fd._device(0)
    assert (sms, smem) == (HOPPER.sms, (HOPPER.smem_per_block_optin,
                                        HOPPER.smem_per_sm,
                                        HOPPER.smem_reserved_per_block))


def _launch_case(name):
    """(metas, run) of one small launch of kernel ``name``."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_adagrad as fa
    from repro_torch.kernels import gba_aggregate as gg
    from repro_torch.kernels import gba_apply as ga
    from repro_torch.kernels import quantize as qz
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ids, table = _inputs(8, 16, 1000, 64, torch.float32, seed=3, odd=True)
    tokens = torch.tensor([9, 4, 9, 8], dtype=torch.int32, device="cuda")
    x = randn(4, 4096)
    if name == "embedding_bag":
        return (eb.fwd_launch_meta(8, 16, 1000, 64),), lambda: embedding_bag(
            ids, table)
    if name == "embedding_bag_grad segment":
        return (eb.bwd_launch_meta(8, 16, 1000, 16),), lambda: \
            embedding_bag_grad(ids, randn(8, 16), 1000)
    if name == "embedding_bag_grad counts":
        return (eb.bwd_launch_meta(8, 16, 100_000, 0),), lambda: \
            embedding_bag_grad(ids, randn(8, 0), 100_000)
    if name == "embedding_bag_grad_resident":
        return (eb.resident_launch_meta(8, 16, 1000, 16),), lambda: \
            embedding_bag_grad_resident(ids, randn(8, 16), 1000)
    if name == "gba_apply":              # N % 4 != 0: one column a thread
        return (ga.launch_meta(4099, 4),), lambda: gba_apply(
            randn(4099), randn(4099).abs(), randn(4, 4099), tokens, 9, 1e-3,
            iota=4)
    if name == "gba_aggregate":
        return (gg.launch_meta(8192, 4, torch.bfloat16),), lambda: \
            gba_aggregate(randn(4, 8192, dtype=torch.bfloat16), tokens, 9,
                          iota=4)
    if name == "fused_adagrad":
        return (fa.launch_meta(10_001, torch.bfloat16),), lambda: \
            fused_adagrad(randn(10_001, dtype=torch.bfloat16),
                          randn(10_001), randn(10_001).abs(), 1e-3)
    if name in ("quantize_minmax", "quantize_sign"):
        mode = name.split("_")[1]
        fn = quantize_minmax if mode == "minmax" else quantize_sign
        return (qz.quantize_launch_meta(4, 4096, 512, mode),), lambda: fn(
            x.clone(), tile=512)
    if name == "dequantize":
        q, scale, zero = quantize_minmax(x.clone(), tile=512)
        return (qz.dequant_launch_meta(4, 4096, 512, "minmax"),), lambda: \
            dequantize(q, scale, zero, tile=512, mode="minmax",
                       out=torch.empty_like(x))
    dtype = torch.bfloat16 if name == "flash_decode ring" else torch.float32
    hd = 80 if dtype == torch.bfloat16 else 112
    q = randn(2, 4, 2, hd, dtype=dtype)
    k, v = randn(2, 1000, 4, hd, dtype=dtype), randn(2, 1000, 4, hd,
                                                   dtype=dtype)
    metas = fd.launch_meta(2, 1000, 4, 2, hd, dtype)
    return (metas if isinstance(metas, tuple) else (metas,)), lambda: \
        flash_decode(q, k, v, 900)


@pytest.mark.parametrize("name", [
    "embedding_bag", "embedding_bag_grad segment",
    "embedding_bag_grad counts", "embedding_bag_grad_resident", "gba_apply",
    "gba_aggregate", "fused_adagrad", "quantize_minmax", "quantize_sign",
    "dequantize", "flash_decode ring", "flash_decode split"])
def test_launch_meta_is_the_recorded_launch(name, compiled):
    """One launch of the kernel at a small shape through its wrapper,
    recorded by ``torch.profiler``: its grid, block and shared memory (the
    meta's dynamic bytes plus the compiler's static bytes) as the meta
    says, and no launch rule finding under the card's limits."""
    _need_card()
    from repro_torch.kernels.launch_record import (device_limits, hold,
                                                   record_launches)
    metas, run = _launch_case(name)
    _, events = record_launches(run, compiled)
    assert len(events) == len(metas), [e["name"] for e in events]
    limits = device_limits(0)
    for meta, event in zip(metas, events):
        row, problems = hold(meta, event, compiled, limits)
        assert not problems, (row, problems)
