"""Mesh descriptions: axis names and sizes, for the sharding rules and the
launcher's ``--mesh``.

Counterpart of ``repro.launch.mesh``.  A :class:`Mesh` here is a plain,
frozen description: it allocates nothing and opens no process group.  The
rule tables of ``repro_torch.distributed.sharding`` read it as the
reference's read a ``jax.sharding.Mesh``: ``axis_names`` and ``shape``
(name -> size).  The reference's production meshes are kept as
descriptions, so that the tables can be checked at their sizes; the
hardware constants the reference keeps beside them belong to its TPU
roofline, which is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, in order (the last varies fastest)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: (data 16, model 16), or (pod 2,
    data 16, model 16) across two pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_smoke_mesh() -> Mesh:
    """(data 1, model 1): the production axis names on one device."""
    return Mesh(("data", "model"), (1, 1))


def parse_mesh(text: str) -> Mesh:
    """``"WxT"`` (or ``"W"``, T = 1) -> the (data W, model T) mesh;
    ``ValueError`` for anything else."""
    data, sep, model = text.partition("x")
    try:
        w, t = int(data), int(model) if sep else 1
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected WxT, e.g. 2x2") from None
    return Mesh(("data", "model"), (w, t))
