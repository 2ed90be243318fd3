"""The port's paper benches against the JAX package's, on the CPU.

* ``convergence.run`` and ``tab52_qps.run`` are numpy over copies of the
  reference's code: every row equals the reference bench's, field for
  field, except ``us_per_call``.
* ``fig3_grad_distribution.run`` at full width and ``n_samples=2``, both
  from the reference's draw of ``PRNGKey(0)``: the norm means within
  rtol 1e-3 (20 Adam steps of float32 rounding in other orders).
* ``multitask``, ``decay_ablation`` and ``fig78_batch_ablation`` at their
  smallest day counts, with each bench's configs cut to a 2048-row table
  and a 32 -> 16 tower: the reference bench's own ``run``, its training
  names pointed at the port's trainer on the CPU, gives the same rows as
  the port's bench, row names, keys and values (all but
  ``us_per_call``).  So the port's benches run the reference's protocols;
  that the port's trainer agrees with the JAX trainer on all three models
  is held in ``tests/test_torch_trainer.py``.  (The JAX benches at full
  width on the CPU and the port's agree to the printed 4th decimal but
  one AUC, 1e-4: ``chip_smoke.py`` holds the multitask AUCs on the card
  within 0.01 of the JAX bench's.)
* Each bench's CLI runs on the CPU.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (convergence, decay_ablation,
                                    fig3_grad_distribution,
                                    fig78_batch_ablation, multitask,
                                    tab52_qps)
from repro_torch.convert import jax_init_recsys
from repro_torch.core import (GBATrainer, ModeSetup, default_setups,
                              evaluate, run_continual)
from repro_torch.data import make_clickstream
from repro_torch.optim import get_optimizer
from repro_torch.sim.cluster import ClusterSpec, Schedule, Slot, simulate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The small models here run thousands of tiny operators: one
    intra-op thread keeps them from contending with the suite's other
    workers (an oversubscribed thread pool slowed them 100-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference(name: str):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(f"benchmarks.{name}", fromlist=["run"])
    finally:
        sys.path.remove(str(ROOT))


def _fields(row: str) -> tuple[str, dict]:
    name, _, derived = row.split(",", 2)
    return name, dict(kv.split("=", 1) for kv in derived.split(";")
                      if "=" in kv)


def _strip_us(row: str) -> str:
    name, _, derived = row.split(",", 2)
    return f"{name},{derived}"


def _tiny(cfg):
    return dataclasses.replace(cfg, hash_capacity=2048, mlp_dims=(32, 16))


def test_convergence_rows_equal_the_reference():
    want = [_strip_us(r) for r in _reference("bench_convergence").run()]
    assert [_strip_us(r) for r in convergence.run()] == want


def test_tab52_rows_equal_the_reference():
    want = [_strip_us(r) for r in _reference("bench_tab52_qps").run()]
    got = [_strip_us(r) for r in tab52_qps.run()]
    assert got == want
    assert "claim_2.4x=PASS" in got[-1]


def test_fig3_matches_the_reference_from_the_same_draw():
    want = _reference("bench_fig3_grad_distribution").run(n_samples=2)
    got = fig3_grad_distribution.run(n_samples=2, device="cpu")
    assert [_fields(r)[0] for r in got] == [_fields(r)[0] for r in want]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(float(_fields(g)[1]["mean"]),
                                   float(_fields(w)[1]["mean"]), rtol=1e-3,
                                   err_msg=g)
    assert _fields(got[-1])[1].keys() == _fields(want[-1])[1].keys()


def _on_the_port(monkeypatch, ref, **configs) -> None:
    """Point the reference bench's training names at the port's (on the
    CPU), and its configs at ``configs``: the bench's own protocol and
    rows then run over the port's trainer."""
    port = {"make_clickstream": make_clickstream, "ClusterSpec": ClusterSpec,
            "default_setups": default_setups, "ModeSetup": ModeSetup,
            "run_continual": run_continual, "GBATrainer": GBATrainer,
            "evaluate": evaluate, "get_optimizer": get_optimizer,
            "simulate": simulate, "Schedule": Schedule, "Slot": Slot,
            "init_recsys": _reference_draw, **configs}
    for name, value in port.items():
        if hasattr(ref, name):
            monkeypatch.setattr(ref, name, value)


def _reference_draw(key, cfg):
    assert np.asarray(key).tolist() == [0, 0]        # PRNGKey(0)
    return jax_init_recsys(cfg, 0, device="cpu")


def _assert_rows_equal(got: list[str], want: list[str]) -> None:
    assert [_strip_us(r) for r in got] == [_strip_us(r) for r in want]


def test_multitask_runs_the_reference_protocol(monkeypatch):
    ref = _reference("bench_multitask")
    configs = tuple(_tiny(c) for c in multitask.CONFIGS)
    _on_the_port(monkeypatch, ref, ALIMAMA_DIEN=configs[0],
                 PRIVATE_YOUTUBEDNN=configs[1])
    monkeypatch.setattr(multitask, "CONFIGS", configs)
    got = multitask.run(base_days=1, eval_days=1, device="cpu")
    _assert_rows_equal(got, ref.run(base_days=1, eval_days=1))
    assert [_fields(r)[0] for r in got] == [
        "multitask.alimama-dien", "multitask.private-youtubednn",
        "multitask.done"]


def test_decay_ablation_runs_the_reference_protocol(monkeypatch):
    ref = _reference("bench_decay_ablation")
    cfg = _tiny(decay_ablation.CFG)
    _on_the_port(monkeypatch, ref, CFG=cfg)
    monkeypatch.setattr(decay_ablation, "CFG", cfg)
    got = decay_ablation.run(base_days=1, device="cpu")
    _assert_rows_equal(got, ref.run(base_days=1))
    assert _fields(got[0])[1] == {"avg_stale": "0.18", "max_stale": "4",
                                  "drops": "17"}


def test_fig78_runs_the_reference_protocol(monkeypatch):
    ref = _reference("bench_fig78_batch_ablation")
    cfg = _tiny(fig78_batch_ablation.CFG)
    _on_the_port(monkeypatch, ref, CFG=cfg)
    monkeypatch.setattr(fig78_batch_ablation, "CFG", cfg)
    got = fig78_batch_ablation.run(base_days=1, eval_days=1, device="cpu")
    _assert_rows_equal(got, ref.run(base_days=1, eval_days=1))
    assert len(got) == 9


@pytest.mark.parametrize("bench, argv", [
    (convergence, []),
    (tab52_qps, ["--num-batches", "64", "--device", "cpu"]),
    (fig3_grad_distribution, ["--n-samples", "1", "--device", "cpu"])],
    ids=["convergence", "tab52_qps", "fig3"])
def test_bench_cli_on_the_cpu(bench, argv, capsys):
    rows = bench.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out == rows and len(rows) > 1
