"""The collectives of the worker-parallel steps, for W workers and W PS
shards in one process on one device.

Counterpart of the ``lax`` collectives that the reference's
worker-parallel programs (``repro.core.gba_shard_map``'s steps and the
sharded fused step of ``repro.launch.programs``) issue along the mesh's
``data`` axis.  With every worker and shard on one device, each is a
copy or nothing: the flat parameter vector is shared, so the tiled
``all_gather`` of a layer group's sub-slices is a view of it, the
``all_to_all`` of a worker's gradient block is a strided copy into the
shards' receive buffer, the reduce-scatter of the one gradient is that
gradient, the ordered ``psum`` is a sum in worker order, and the
workers' losses are already all here.  Along the ``model`` axis
(``distributed.tensor_parallel``) every model shard is held here too, so
the gather of the shards' tensors is those tensors; and along ``data``
under FSDP (``distributed.fsdp``) every data shard's rows are here, so
the gather of a leaf is the concatenation of the held blocks' rows, and
the reduction of its gradient is this process's gradient.
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


def model_shards(t: int) -> range:
    """The model shards held here: all ``t``."""
    return range(t)


def model_gather(parts: list) -> list:
    """Every model shard's tensor, in shard order, from the held shards':
    ``parts``, which are all of them."""
    return list(parts)


def data_gather(parts: list, dim: int) -> torch.Tensor:
    """A leaf whole over ``data`` from the held data shards' rows
    ``parts`` (all of them, in shard order): their concatenation along
    ``dim``, a new tensor."""
    return torch.cat(parts, dim=dim)


def data_reduce(whole: torch.Tensor, dim: int) -> torch.Tensor:
    """The held data shards' rows, along ``dim``, of the sum over the
    processes of their float32 ``whole`` gradients: ``whole``, this
    process's alone, which holds every row."""
    return whole


def data_sum(partial: torch.Tensor) -> torch.Tensor:
    """The sum over the processes of their float32 ``partial`` gradients
    of a leaf whole over ``data``: ``partial``, this process's alone."""
    return partial


def gather_flat(run: torch.Tensor) -> torch.Tensor:
    """The whole shard-major vector from the processes' runs of it:
    ``run``, which is already the whole vector."""
    return run


def gather_group(layout: ShardedFlatLayout, g: int,
                 param_flat: torch.Tensor) -> torch.Tensor:
    """The tiled ``all_gather`` of layer group ``g``: every shard's
    group-``g`` sub-slice of the shard-major ``param_flat``, as the
    group's ``(num_shards, group_shard)`` rows, here a view of
    ``param_flat``."""
    return layout.group_rows(param_flat, g)


def all_gather(layout: ShardedFlatLayout, param_flat: torch.Tensor):
    """Every worker's view of the whole parameter tree from the shards'
    ``(shard_size,)`` slices of the shard-major ``param_flat``: one
    :func:`gather_group` a layer group, in group order, each group's
    leaves unraveled from it, each leaf in its own dtype and storage.
    One tree serves every worker, since each worker's gather would give
    the same values."""
    return layout.unravel_groups(
        gather_group(layout, g, param_flat) for g in range(layout.num_groups))


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
