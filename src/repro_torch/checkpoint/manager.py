"""Step-numbered checkpoint manager with retention, for continual training.

Counterpart of ``repro.checkpoint.manager``; the files are
``ckpt_<step:08d>.npz`` in the JAX package's layout, so either package
restores the other's:

    mgr = CheckpointManager(dir, keep=3)
    mgr.save(step, {"params": ..., "opt": ..., "last_update": ...})
    step, state = mgr.restore_latest()            # onto the card

The paper's continual protocol (inherit yesterday's checkpoint, train
today under whichever mode the cluster favours) maps onto save/restore of
the full train state, including the per-ID ``last_update`` staleness tags.
"""
from __future__ import annotations

import os
import re
from typing import Any

import torch

from repro_torch.checkpoint.store import load_pytree, save_pytree
from repro_torch.convert import tree_to_device
from repro_torch.kernels.runtime import resolve_device

_PAT = re.compile(r"ckpt_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _PAT.match(f)))

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` as step ``step``, then remove all but the newest
        ``keep`` checkpoints."""
        path = self._path(step)
        save_pytree(path, state)
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))
        return path

    def restore(self, step: int, *,
                device: str | torch.device = "cuda") -> Any:
        """The state saved as step ``step``, its tensors on ``device``."""
        return tree_to_device(load_pytree(self._path(step)),
                              resolve_device(device))

    def restore_latest(self, *, device: str | torch.device = "cuda"
                       ) -> tuple[int, Any]:
        step, _ = self.latest_path()
        return step, self.restore(step, device=device)

    def latest_path(self) -> tuple[int, str]:
        """(step, path) of the newest checkpoint: what a serving
        ``StaticSource.from_checkpoint`` resolves a directory to."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return steps[-1], self._path(steps[-1])
