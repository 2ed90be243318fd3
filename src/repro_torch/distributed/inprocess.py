"""The collectives of the worker-parallel steps, for W workers and W PS
shards in one process on one device.

Counterpart of the ``lax`` collectives that the reference's
worker-parallel programs (``repro.core.gba_shard_map``'s steps and the
sharded fused step of ``repro.launch.programs``) issue along the mesh's
``data`` axis.  With every worker and shard on one device, each is a
copy or nothing: the flat parameter vector is shared, so the tiled
``all_gather`` of the shards' slices is one unravel of it, the
``all_to_all`` of a worker's gradient block is a strided copy into the
shards' receive buffer, the reduce-scatter of the one gradient is that
gradient, the ordered ``psum`` is a sum in worker order, and the
workers' losses are already all here.
``repro_torch.distributed.process_group`` provides the same functions
over ``torch.distributed`` ranks.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core.flat_sharded import ShardedFlatLayout

# the processes the workers are spread over: this one
size = 1


def workers(m: int) -> range:
    """The workers, and the shards of the same indices, held here: all
    ``m``."""
    return range(m)


def gather_flat(run: torch.Tensor) -> torch.Tensor:
    """The whole shard-major vector from the processes' runs of it:
    ``run``, which is already the whole vector."""
    return run


def all_gather(layout: ShardedFlatLayout, param_flat: torch.Tensor):
    """Every worker's view of the whole parameter tree from the shards'
    ``(shard_size,)`` slices of the shard-major ``param_flat``: the tree,
    each leaf in its own dtype and storage.  One tree serves every
    worker, since each worker's gather would give the same values."""
    return layout.unravel(param_flat)


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """The held shards' columns of the sum over the processes of their
    shard-major ``flat`` gradients: ``flat``, this process's alone."""
    return flat


def worker_sum(terms: Iterable[tuple[list, torch.Tensor]], like: list
               ) -> list:
    """The sum over the workers, in worker order from +0.0, of ``tensors
    * scale`` (``scale`` cast to each tensor's dtype): ``terms`` yields
    each held worker's ``(tensors, scale)`` in worker order (here all
    ``m``), and each sum starts as zeros of the tensor of ``like`` at its
    position.  A term is dropped once added."""
    acc = [torch.zeros_like(x) for x in like]
    for tensors, scale in terms:
        for a, t in zip(acc, tensors, strict=True):
            a.add_(t * scale.to(t.dtype))
        del tensors
    return acc


def route(dst: torch.Tensor, worker: int, lo: int, hi: int,
          src: torch.Tensor) -> None:
    """The ``all_to_all`` of one layer group: row ``s`` of ``worker``'s
    ``(S, hi - lo)`` block ``src`` goes to shard ``s``, which keeps it at
    row ``worker``, columns ``lo:hi`` of its ``(M, cols)`` receive buffer
    ``dst[s]``.  ``dst`` is the shards' ``(S, M, cols)`` buffers, so each
    shard reads one contiguous block once every worker has routed."""
    dst[:, worker, lo:hi].copy_(src)


def all_losses(losses: list) -> list:
    """The scalar losses of every process, in process order: ``losses``,
    this process's."""
    return losses
