"""The ``torch.distributed`` backend of the wire step on the CPU: gloo
ranks held bit for bit to the in-process backend, the launcher's
``--ranks``, and the refusals.

The in-process backend is itself held to the JAX package's wire step in
``tests/test_torch_wire.py``; the reference has no process-group
counterpart to run here.  ``repro_torch.distributed.selfcheck`` runs the
wire step on a problem whose gradients are exact, for none, int8 and
onebit, on R ranks of W / R workers and then in process; one world is
spawned per R for all three schemes.  The launcher test prints losses to
4 decimals, which the in-process LM step on this CPU matches whatever its
thread count.  Every spawn has a timeout of its own and leaves no rank
running.
"""
import multiprocessing
import os
import types

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import inprocess, process_group, selfcheck
from repro_torch.launch import train

W = 4
SCHEMES = ("none", "int8", "onebit")
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module", params=[2, 4], ids=lambda r: f"ranks{r}")
def report(request):
    return request.param, selfcheck.compare(request.param, W, SCHEMES,
                                            device="cpu",
                                            timeout=SPAWN_TIMEOUT)


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


def test_ranks_with_compress_none_is_refused(capsys):
    """``--compress none`` runs the sharded fused step, which is not
    ported over ranks: ``--ranks`` does not swap in the wire step."""
    with pytest.raises(SystemExit):
        train.main(["--arch", "granite-8b", "--reduced", "--fused", "--mesh",
                    "4x1", "--ranks", "2", "--device", "cpu"])
    assert "--ranks with --compress none" in capsys.readouterr().err
    assert not dist.is_initialized()


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


def test_launcher_runs_the_wire_step_on_two_gloo_ranks(capfd):
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
