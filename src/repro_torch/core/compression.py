"""Wire-compression policy of the layer-grouped worker-parallel PS step.

Counterpart of ``repro.core.compression``.  :class:`CompressionPolicy`
declares how the gradient-routing stage (worker -> shard) is compressed:

``none``
    float32 gradients on the wire.
``int8``
    per tile-aligned slice, min-max affine int8 codes plus two float32
    sideband words (scale, zero point), with a per-worker error-feedback
    residual.
``onebit``
    full-precision routing for ``warmup_steps`` global steps while a
    per-worker momentum EMA accumulates, then ``sign(momentum + residual)``
    as int8 plus one float32 per-tile mean-|x| norm, with the residual.

The residual and the momentum live in ``(M, padded_total)`` float32 rows,
one per worker, in the layout's shard-major column order, so group ``g``
of worker ``w`` is the same ``group_shard_bounds`` column slice of each of
its ``num_shards`` rows as its gradient block.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

SCHEMES = ("none", "int8", "onebit")
MOMENTUM = 0.9          # onebit's EMA coefficient, the reference's default


@dataclass(frozen=True)
class CompressionPolicy:
    """Declared compression of the gradient-routing wire: ``warmup_steps``
    global steps route float32 before the compressed wire switches on."""

    scheme: str = "none"
    warmup_steps: int = 0

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown compression scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, "
                             f"got {self.warmup_steps}")

    @property
    def stateful(self) -> bool:
        """Whether the step carries wire state (residual, momentum)."""
        return self.scheme != "none"

    def state_names(self) -> tuple[str, ...]:
        return {"none": (), "int8": ("residual",),
                "onebit": ("residual", "momentum")}[self.scheme]

    def init_wire_state(self, layout, m: int,
                        device: str | torch.device) -> dict:
        """Zero wire state on ``device``: one ``(m, padded_total)``
        float32 row per worker for each of :meth:`state_names`."""
        return {name: torch.zeros((m, layout.padded_total),
                                  dtype=torch.float32, device=device)
                for name in self.state_names()}

    def wire_dtype(self) -> str:
        """Dtype of the gradient payload on the compressed routing wire."""
        return "float32" if self.scheme == "none" else "int8"

    def sideband_floats_per_tile(self) -> int:
        """float32 sideband words routed per quantization tile."""
        return {"none": 0, "int8": 2, "onebit": 1}[self.scheme]

    def route_bytes(self, group_size: int, tile: int) -> int:
        """Bytes one group's compressed routing stage puts on the wire per
        worker and global step (payload and sideband)."""
        if self.scheme == "none":
            return group_size * 4
        if group_size % tile:
            raise ValueError(f"group_size {group_size} not a multiple of "
                             f"tile {tile}")
        return group_size + self.sideband_floats_per_tile() * (
            group_size // tile) * 4

    def wire_bytes(self, layout) -> int:
        """Compressed gradient bytes on the wire per worker and global
        step."""
        return sum(self.route_bytes(gs, layout.tile)
                   for gs in layout.group_sizes)

    def compression_ratio(self, layout) -> float:
        """Compressed over float32 routed bytes (1.0 for ``none``)."""
        return self.wire_bytes(layout) / (layout.padded_total * 4)
