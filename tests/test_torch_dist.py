"""The ``torch.distributed`` backend of the worker-parallel steps on the
CPU: gloo ranks held bit for bit to the in-process backend, the
launchers' ``--ranks``, and the refusals.

The in-process backend is itself held to the JAX package's steps in
``tests/test_torch_wire.py``, ``tests/test_torch_switch_driver.py``,
``tests/test_torch_switch_lm.py`` and ``tests/test_torch_sharded_fused.py``;
the reference has no process-group counterpart to run here.
``repro_torch.distributed.selfcheck`` runs every case on R ranks of W / R
workers and then in process, one world spawned per R for all of them:
the wire step for none, int8 and onebit, the psum sync step, a switched
``run_schedule`` with ``sync_impl="psum"`` and the sharded fused step on a
problem whose gradients are exact (also with the weights held over
``data``, FSDP), and the switching harness on the demo
MLP (``run(mode="auto")`` on the strained plan, the swap schedule, a NaN
batch on the last rank's worker), one intra-op thread on both sides,
since CPU matmuls round by thread count.

The launcher tests run one intra-op thread too, which the ranks inherit
(a launcher's gloo rank runs the launching process's thread count): the
wire step and the switching harness then print the in-process run's
losses.  The sharded fused step splits each microstep's batch over the
ranks: its loss is the sum of the ranks' shares, and the bf16 reduced
LM's half-batch gradients round to bf16 before they are summed, so its
printed losses are held within 5e-4 (2.3e-4 apart after 8 microsteps
on an 8-core CPU) and the float32 LM's to 4 decimals.  Every spawn has a
timeout of its own and leaves no rank running.
"""
import dataclasses
import json
import multiprocessing
import os
import re
import types

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import inprocess, process_group, selfcheck
from repro_torch.launch import switch_driver, train

W = 4
SCHEMES = ("none", "int8", "onebit")
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module", params=[2, 4], ids=lambda r: f"ranks{r}")
def checked(request):
    held = {}
    rep = selfcheck.compare(request.param, W, selfcheck.CASES, device="cpu",
                            timeout=SPAWN_TIMEOUT, held=held)
    return request.param, rep, held


@pytest.fixture
def report(checked):
    return checked[:2]


@pytest.fixture
def one_thread():
    """One intra-op thread here, and so in the ranks a launcher spawns."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gloo_wire_step_is_bit_identical_to_in_process(report, scheme):
    """Params, accumulator, every rank's losses and the wire state (the
    residual; and the momentum for onebit) after 3 global steps, the first
    a float32 warmup."""
    ranks, rep = report
    want = {"none": {"param", "accum", "loss"},
            "int8": {"param", "accum", "loss", "residual"},
            "onebit": {"param", "accum", "loss", "residual", "momentum"}}
    assert set(rep[scheme]) == want[scheme]
    assert rep[scheme] == {k: 0 for k in want[scheme]}, (ranks, rep)


def test_gloo_psum_step_is_bit_identical_to_in_process(report):
    """The pytree all-reduce step over 3 global steps: the replicated
    params, Adagrad accumulator and losses on every rank, the ranks'
    workers summed in worker order through the chain."""
    ranks, rep = report
    assert rep["psum"] == {"params": 0, "opt": 0, "loss": 0}, (ranks, rep)


def test_gloo_switched_schedule_is_bit_identical_to_in_process(checked):
    """``run_schedule`` of sync x3, gba x3, sync x2 with the psum sync
    step: the gathered flat state, the losses and the ``SwitchResult`` on
    every rank; both swaps verified, one slot dropped, one tombstone."""
    ranks, rep, held = checked
    assert rep["switched"] == {"param_flat": 0, "accum_flat": 0, "loss": 0,
                               "result": 0}, (ranks, rep)
    res = json.loads(held["switched"]["result"])
    assert res["swaps_verified"] == 2 and res["switch_count"] == 2
    assert res["dropped_batches"] == 1 and res["tombstones"] == 1


def test_gloo_sharded_fused_step_is_bit_identical_to_in_process(checked):
    """3 applies of the sharded fused step, each microstep's batch split
    over the ranks: the gathered params and the ranks' runs of the
    accumulator bit for bit, one ``gba_apply`` launch per held shard at
    each apply (k a rank, W in process), the losses (sums of the ranks'
    shares) within 1e-6."""
    ranks, rep, held = checked
    fused = rep["fused"]
    assert fused.pop("loss") < 1e-6, (ranks, rep)
    assert fused == {"params": 0, "accum": 0, "launches_per_shard": 0}, \
        (ranks, rep)
    assert held["fused"]["launches_per_shard"].tolist() == [1.0] * (
        selfcheck.FUSED_STEPS // selfcheck.FUSED_M)


def test_gloo_fsdp_step_is_bit_identical_to_in_process(checked):
    """The sharded fused step with the weights over ``data`` (FSDP) on
    the exact problem, 2 and 4 data ranks: the params gathered over
    ``data`` and the ranks' runs of the accumulator bit for bit the
    in-process run's, one launch per held shard an apply, the losses
    within 1e-6; on every process the run bit for bit the same step with
    ``place_state=False``, and the blocks holding exactly the rules'
    share of the bytes."""
    ranks, rep, held = checked
    fsdp = rep["fsdp"]
    assert fsdp.pop("loss") < 1e-6, (ranks, rep)
    assert fsdp == {"params": 0, "accum": 0, "launches_per_shard": 0,
                    "bytes": 0, "vs_unplaced": 0}, (ranks, rep)
    assert held["fsdp"]["vs_unplaced"].tolist() == [0, 0, 0]
    assert held["fsdp"]["bytes"].tolist() == [0]
    assert held["fsdp"]["launches_per_shard"].tolist() == [1.0] * (
        selfcheck.FUSED_STEPS // selfcheck.FUSED_M)


@pytest.mark.parametrize("case", ["demo_auto", "demo_schedule"])
def test_gloo_switch_driver_on_the_demo_is_bit_identical_to_in_process(
        checked, case):
    """The demo MLP: ``run(mode="auto")`` on the strained plan and the
    swap schedule, each with the psum sync step; the ``SwitchResult``
    (every simulated field and the final loss), the flat state and the
    losses equal on every rank to the one-thread in-process run's."""
    ranks, rep, held = checked
    assert rep[case] == {"param_flat": 0, "accum_flat": 0, "loss": 0,
                         "result": 0}, (ranks, rep)
    res = json.loads(held[case]["result"])
    assert res["switch_count"] >= 1 and res["swaps_verified"] >= 1


def test_a_nan_batch_on_one_rank_commits_nothing_on_any_rank(checked):
    """The last worker's batch all NaN, on the last rank: every rank skips
    the apply (psum sync, fused sync, async), and after a compressed step
    every rank restarts the wire (warmup count and residual 0)."""
    ranks, rep, held = checked
    modes = ("psum_sync", "fused_sync", "async", "int8_async")
    assert rep["demo_nan"] == {k: 0 for k in modes}, (ranks, rep)
    assert all(held["demo_nan"][k].item() == 0 for k in modes)


@pytest.fixture
def one_rank_world(tmp_path):
    """A gloo world of one rank in this process."""
    threads = torch.get_num_threads()
    world, _ = process_group.join(0, 1, f"file://{tmp_path / 'store'}",
                                  "cpu", timeout=60.0)
    yield world
    process_group.leave()
    torch.set_num_threads(threads)


def test_one_rank_world_is_bit_identical_to_in_process(one_rank_world,
                                                       tmp_path):
    """One rank holding all 4 workers, as the card's NCCL world does."""
    assert list(one_rank_world.workers(W)) == list(range(W))
    os.mkdir(tmp_path / "one")
    os.mkdir(tmp_path / "in")
    selfcheck.run(one_rank_world, torch.device("cpu"), W, SCHEMES,
                  str(tmp_path / "one"))
    selfcheck.run(inprocess, torch.device("cpu"), W, SCHEMES,
                  str(tmp_path / "in"))
    got = torch.load(tmp_path / "one" / "part0.pt")
    want = torch.load(tmp_path / "in" / "part0.pt")
    for scheme in SCHEMES:
        for k, v in want[scheme].items():
            assert torch.equal(got[scheme][k].view(torch.int32),
                               v.view(torch.int32)), (scheme, k)


def test_gloo_refuses_cuda_tensors(one_rank_world):
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    lay = types.SimpleNamespace(padded_total=4)
    with pytest.raises(ValueError, match="gloo carries cpu tensors"):
        one_rank_world.all_gather(lay, cuda)
    with pytest.raises(ValueError, match="gloo carries cpu tensors"):
        one_rank_world.route(cuda, 0, 0, 1, cuda)
    for collective in (one_rank_world.gather_flat,
                       one_rank_world.reduce_scatter):
        with pytest.raises(ValueError, match="gloo carries cpu tensors"):
            collective(cuda)
    with pytest.raises(ValueError, match="gloo carries cpu tensors"):
        one_rank_world.worker_sum(iter(()), [cuda])


def test_ranks_must_divide_workers():
    with pytest.raises(ValueError, match="3 ranks must divide 4 workers"):
        process_group.check_world(3, 4, "cpu")
    with pytest.raises(ValueError, match="3 ranks must divide 4 workers"):
        train.main(["--arch", "granite-8b", "--reduced", "--fused", "--mesh",
                    "4x1", "--compress", "int8", "--ranks", "3", "--device",
                    "cpu"])
    with pytest.raises(SystemExit):
        train.main(["--arch", "granite-8b", "--reduced", "--fused",
                    "--ranks", "2", "--device", "cpu"])


def _losses(out: str) -> list[float]:
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ")]


def test_ranks_with_compress_none_runs_the_sharded_fused_step(capfd,
                                                              one_thread):
    """``--compress none --ranks 2`` runs the sharded fused step over two
    gloo ranks, each with 2 of the 4 shards and half of each microstep's
    sequences: the step and gstep columns of the in-process run, the bf16
    losses within 5e-4 of its."""
    args = ["--arch", "granite-8b", "--reduced", "--fused", "--mesh", "4x1",
            "--buffer", "2", "--steps", "8", "--seq", "16", "--device",
            "cpu"]
    train.main(args + ["--ranks", "2"])
    ranked = capfd.readouterr().out
    assert "process group: gloo, 2 ranks x 2 shards, 2 sequences" in ranked
    assert ranked.count("sharded fused gba_apply path") == 1  # rank 0 alone
    train.main(args)
    local = capfd.readouterr().out
    assert [line.split()[:2] + line.split()[4:6]
            for line in ranked.splitlines() if line.startswith("step ")] \
        == [line.split()[:2] + line.split()[4:6]
            for line in local.splitlines() if line.startswith("step ")]
    assert len(_losses(local)) == 3
    assert max(abs(a - b) for a, b in zip(_losses(ranked),
                                          _losses(local))) <= 5e-4
    assert not dist.is_initialized()


def test_sharded_fused_float32_lm_on_two_ranks_prints_the_losses(capfd,
                                                                 one_thread):
    """The float32 reduced LM, whose half-batch gradients do not round to
    bf16: the ranks' losses to 4 decimals as in process."""
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              dtype="float32")
    kw = dict(steps=6, batch=4, seq=16, buffer=2, workers=4)
    process_group.spawn(train.on_rank, 2, train.run_lm_fused, cfg, kw,
                        device="cpu", timeout=SPAWN_TIMEOUT)
    ranked = _step_lines(capfd.readouterr().out)
    want = train.run_lm_fused(cfg, device="cpu", **kw)
    assert ranked == _step_lines(capfd.readouterr().out)
    assert [float(line.split()[3]) for line in ranked] == [
        round(want[i], 4) for i in (0, 5)]


def test_more_nccl_ranks_than_cards_is_refused(monkeypatch):
    """NCCL runs one rank per GPU: with one visible card, 2 ranks on
    ``cuda`` raise before anything starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        process_group.check_world(2, 4, "cuda")
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        train.main(["--arch", "granite-8b", "--reduced", "--fused", "--mesh",
                    "4x1", "--compress", "int8", "--ranks", "2"])
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        selfcheck.compare(2, W, SCHEMES, device="cuda")
    for args in (["--fused", "--mesh", "4x1"], ["--mesh", "4x1",
                                                "--autoswitch"]):
        with pytest.raises(RuntimeError, match="one rank per GPU"):
            train.main(["--arch", "granite-8b", "--reduced", "--ranks", "2",
                        *args])
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        switch_driver.main(["--ranks", "2"])
    with pytest.raises(RuntimeError, match="one rank per GPU"):
        process_group.spawn(selfcheck.run, 2, W, SCHEMES, "unused")
    assert not dist.is_initialized()


def test_a_failing_rank_fails_the_spawn_and_leaves_none_running(tmp_path):
    """3 workers cannot split over 2 ranks: each rank raises, and so does
    the spawn, with the rank's message."""
    with pytest.raises(Exception, match="2 ranks must divide 3 workers"):
        process_group.spawn(selfcheck.run, 2, 3, ("none",), str(tmp_path),
                            device="cpu", timeout=SPAWN_TIMEOUT)
    assert not multiprocessing.active_children()


def _step_lines(out: str) -> list[str]:
    return [" ".join(line.split()[:5]) for line in out.splitlines()
            if line.startswith("step ")]


def test_launcher_runs_the_wire_step_on_two_gloo_ranks(capfd, one_thread):
    args = ["--arch", "granite-8b", "--reduced", "--fused", "--mesh", "4x1",
            "--compress", "int8", "--compress-warmup", "1", "--steps", "3",
            "--seq", "16", "--device", "cpu"]
    train.main(args + ["--ranks", "2"])
    ranked = capfd.readouterr().out
    assert "process group: gloo, 2 ranks x 2 workers" in ranked
    assert ranked.count("quantized wire (int8)") == 1    # rank 0 alone
    train.main(args)
    local = capfd.readouterr().out
    assert _step_lines(ranked) == _step_lines(local)
    assert len(_step_lines(local)) == 3


_SUMMARY = re.compile(r"^autoswitch \(strained\): .*$", re.MULTILINE)


def test_launcher_runs_the_switching_harness_on_two_gloo_ranks(capfd,
                                                               one_thread):
    """``--autoswitch --ranks 2`` prints the summary of the run without
    ``--ranks``, number for number (the ranks run this process's one
    thread, so their losses are the in-process run's bits)."""
    args = ["--arch", "granite-8b", "--reduced", "--mesh", "4x1",
            "--autoswitch", "--plan", "strained", "--batches", "24",
            "--seq", "32", "--device", "cpu"]
    train.main(args + ["--ranks", "2"])
    ranked = capfd.readouterr().out
    assert "process group: gloo, 2 ranks x 2 workers" in ranked
    assert len(_SUMMARY.findall(ranked)) == 1            # rank 0 alone
    res = train.main(args)
    local = capfd.readouterr().out
    assert _SUMMARY.findall(ranked) == _SUMMARY.findall(local)
    assert res.switch_count == 1 and res.swaps_verified == 1
    assert not dist.is_initialized()


def test_switch_driver_cli_on_two_gloo_ranks_prints_the_same_result(
        capfd, one_thread):
    """The demo CLI with ``--ranks 2``: rank 0's JSON line equal to the
    in-process CLI's."""
    args = ["--workers", "4", "--batches", "96", "--local-batch", "64",
            "--plan", "strained", "--compare-sync", "--json", "--device",
            "cpu"]
    switch_driver.main(args + ["--ranks", "2"])
    ranked = capfd.readouterr().out.strip().splitlines()
    want = switch_driver.main(args)
    local = capfd.readouterr().out.strip().splitlines()
    assert len(ranked) == 1 and ranked == local
    assert want["switch_count"] >= 1
