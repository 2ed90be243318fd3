"""Step-numbered checkpoint directory: ``ckpt_<step:08d>.npz`` files.

Counterpart of ``repro.checkpoint.manager``; the port needs only the
newest file of a directory, for ``StaticSource.from_checkpoint``.
"""
from __future__ import annotations

import os
import re

_PAT = re.compile(r"ckpt_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _PAT.match(f)))

    def latest_path(self) -> tuple[int, str]:
        """(step, path) of the newest checkpoint."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return steps[-1], self._path(steps[-1])
