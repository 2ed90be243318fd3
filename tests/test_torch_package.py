"""Package rules of the PyTorch port.

* Importing ``repro_torch`` and its serving (the recsys engine, the LM
  engine and launcher), training (the replay trainer, the LM's pytree and
  fused steps, its worker-parallel wire step and that step's process-group
  backend, the token list),
  embeddings, kernel and bench modules and its numpy copy of the
  reference's random draws loads no JAX.
* No file of the port, and neither ``chip_smoke.py`` nor the card scripts
  of ``scripts/``, imports ``jax`` or the JAX package ``repro``.
* Entry points default to ``device="cuda"`` and raise on a machine without
  a card instead of running on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.recsys import CRITEO_DEEPFM
from repro_torch.convert import jax_init_recsys, params_from_jax
from repro_torch.core import pretrain_sync
from repro_torch.benchmarks import (decay_ablation, fig3_grad_distribution,
                                    fig6_switching, fig78_batch_ablation,
                                    multitask)
from repro_torch.launch import quickstart, switch_driver, train
from repro_torch.models.recsys import init_recsys
from repro_torch.models.transformer import init_model
from repro_torch.serving import (RecsysScoringEngine, StaticSource,
                                 init_scoring_params)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|$|,)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.embeddings, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.checkpoint, "
            "repro_torch.configs, repro_torch.data, repro_torch.sim, "
            "repro_torch.metrics, repro_torch.optim, repro_torch.models.recsys, "
            "repro_torch.optim.schedules, repro_torch.checkpoint.manager, "
            "repro_torch.core, repro_torch.launch.quickstart, "
            "repro_torch.launch.train, repro_torch.launch.programs, "
            "repro_torch.models.transformer, repro_torch.core.gba, "
            "repro_torch.data.lm, repro_torch.kernels.gba_apply, "
            "repro_torch.kernels.quantize, repro_torch.core.staleness, "
            "repro_torch.core.compression, repro_torch.core.flat_sharded, "
            "repro_torch.core.gba_shard_map, "
            "repro_torch.distributed.inprocess, repro_torch.core.tokens, "
            "repro_torch.distributed.process_group, "
            "repro_torch.distributed.selfcheck, "
            "repro_torch.kernels.gba_aggregate, "
            "repro_torch.kernels.fused_adagrad, "
            "repro_torch.kernels.flash_decode, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.sim.faults, "
            "repro_torch.core.autoswitch, repro_torch.launch.switch_driver, "
            "repro_torch.benchmarks.fig6_switching, "
            "repro_torch.benchmarks.autoswitch, repro_torch.jax_random, "
            "repro_torch.benchmarks.multitask, "
            "repro_torch.benchmarks.decay_ablation, "
            "repro_torch.benchmarks.fig3_grad_distribution, "
            "repro_torch.benchmarks.fig78_batch_ablation, "
            "repro_torch.benchmarks.convergence, "
            "repro_torch.benchmarks.tab52_qps, repro_torch.analysis, "
            "repro_torch.analysis.__main__, "
            "repro_torch.kernels.launch_record; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_port_sources(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports the JAX side: {hits}"


def test_forbidden_import_pattern():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from repro.kernels import ops", "import repro.serving",
                "  from repro import serving"):
        assert FORBIDDEN.search(bad), bad
    for fine in ("import repro_torch", "from repro_torch.kernels import ops",
                 "import numpy", "# the JAX package repro.serving"):
        assert not FORBIDDEN.search(fine), fine


@pytest.mark.parametrize("entry", ["init_scoring_params", "engine",
                                   "from_checkpoint", "params_from_jax",
                                   "init_recsys", "pretrain_sync",
                                   "quickstart", "train_vocab",
                                   "init_model", "train_arch",
                                   "train_wire", "train_pytree",
                                   "train_sharded", "train_ranks",
                                   "train_autoswitch", "switch_driver",
                                   "fig6_run", "jax_init_recsys",
                                   "multitask_run", "decay_ablation_run",
                                   "fig3_run", "fig78_run"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(
        entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    gen = torch.Generator().manual_seed(0)
    params = init_scoring_params(64, 8, generator=gen, device="cpu")
    calls = {
        "init_scoring_params": lambda: init_scoring_params(64, 8,
                                                           generator=gen),
        "engine": lambda: RecsysScoringEngine(StaticSource(params)),
        "from_checkpoint": lambda: StaticSource.from_checkpoint(
            str(tmp_path / "missing.npz")),
        "params_from_jax": lambda: params_from_jax({"w": [1.0]}),
        "init_recsys": lambda: init_recsys(CRITEO_DEEPFM, generator=gen),
        "pretrain_sync": lambda: pretrain_sync(gen, CRITEO_DEEPFM, None, {},
                                               None, 1),
        "quickstart": lambda: quickstart.main([]),
        "train_vocab": lambda: train.main(["--vocab", "1000", "--steps",
                                           "1"]),
        "init_model": lambda: init_model(get_config("granite-8b").reduced(),
                                         generator=gen),
        "train_arch": lambda: train.main(["--arch", "granite-8b",
                                          "--reduced", "--fused", "--steps",
                                          "1"]),
        "train_pytree": lambda: train.main(["--arch", "granite-8b",
                                            "--reduced", "--steps", "1"]),
        "train_wire": lambda: train.main(["--arch", "granite-8b",
                                          "--reduced", "--fused", "--mesh",
                                          "4x1", "--compress", "int8",
                                          "--steps", "1"]),
        "train_sharded": lambda: train.main(["--arch", "granite-8b",
                                             "--reduced", "--fused",
                                             "--mesh", "4x1", "--steps",
                                             "1"]),
        "train_ranks": lambda: train.main(["--arch", "granite-8b",
                                           "--reduced", "--fused", "--mesh",
                                           "4x1", "--compress", "int8",
                                           "--ranks", "2", "--steps", "1"]),
        "train_autoswitch": lambda: train.main(["--arch", "granite-8b",
                                                "--reduced", "--mesh", "4x1",
                                                "--autoswitch"]),
        "switch_driver": lambda: switch_driver.main(["--batches", "8"]),
        "fig6_run": lambda: fig6_switching.run(1, 1),
        "jax_init_recsys": lambda: jax_init_recsys(CRITEO_DEEPFM),
        "multitask_run": lambda: multitask.run(1, 1),
        "decay_ablation_run": lambda: decay_ablation.run(1),
        "fig3_run": lambda: fig3_grad_distribution.run(1),
        "fig78_run": lambda: fig78_batch_ablation.run(1, 1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
