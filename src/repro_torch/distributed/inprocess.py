"""The collectives of the worker-parallel PS step, for W workers and W
PS shards in one process on one device.

Counterpart of the ``lax`` collectives that
``repro.core.gba_shard_map.make_gba_fused_psum_step`` issues along the
mesh's ``data`` axis.  With every worker and shard on one device, each is
a copy: the flat parameter vector is shared, so the tiled ``all_gather``
of the shards' slices is one unravel of it, the ``all_to_all`` of a
worker's gradient block is a strided copy into the shards' receive
buffer, and the workers' losses are already all here.
``repro_torch.distributed.process_group`` provides the same four
functions over ``torch.distributed`` ranks.
"""
from __future__ import annotations

import torch

from repro_torch.core.flat_sharded import ShardedFlatLayout


def workers(m: int) -> range:
    """The workers, and the shards of the same indices, held here: all
    ``m``."""
    return range(m)


def all_gather(layout: ShardedFlatLayout, param_flat: torch.Tensor):
    """Every worker's view of the whole parameter tree from the shards'
    ``(shard_size,)`` slices of the shard-major ``param_flat``: the tree,
    each leaf in its own dtype and storage.  One tree serves every
    worker, since each worker's gather would give the same values."""
    return layout.unravel(param_flat)


def route(dst: torch.Tensor, worker: int, lo: int, hi: int,
          src: torch.Tensor) -> None:
    """The ``all_to_all`` of one layer group: row ``s`` of ``worker``'s
    ``(S, hi - lo)`` block ``src`` goes to shard ``s``, which keeps it at
    row ``worker``, columns ``lo:hi`` of its ``(M, cols)`` receive buffer
    ``dst[s]``.  ``dst`` is the shards' ``(S, M, cols)`` buffers, so each
    shard reads one contiguous block once every worker has routed."""
    dst[:, worker, lo:hi].copy_(src)


def all_losses(losses: list) -> list:
    """The ``m`` workers' scalar losses in worker order: ``losses``."""
    return losses
