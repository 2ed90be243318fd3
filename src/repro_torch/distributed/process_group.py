"""The collectives of the worker-parallel steps over ``torch.distributed``
ranks.

Counterpart of the ``lax`` collectives that the reference's
worker-parallel programs issue along the mesh's ``data`` axis, where
every device is one worker and one PS shard.  Here R ranks hold W
workers, W divisible by R: rank ``r`` holds the k = W / R consecutive
workers ``r * k ... r * k + k - 1`` and the shards of the same indices.
It keeps only their part of the flat state: the ``(k * shard_size,)``
run of the shard-major ``param_flat`` and accumulator that starts at
column ``r * k * shard_size``, and its workers' ``(k, padded_total)``
wire rows.  :class:`ProcessGroupBackend` offers the functions of
``repro_torch.distributed.inprocess``:

* ``gather_flat``: one tiled all-gather of the ranks' runs into the
  whole ``(padded_total,)`` vector; ``all_gather`` then unravels it;
* ``reduce_scatter``: one ``dist.reduce_scatter_tensor`` of every rank's
  shard-major gradient, each rank keeping its shards' columns of the
  sum (the ranks' terms in an order of the library's own);
* ``worker_sum``: the ``psum`` of the sync step, in worker order: a
  chain over the ranks (rank ``r`` receives the sum of the workers
  before its own, adds its k terms in order and passes it on), then a
  broadcast of the total from the last rank, so every rank holds the
  same bits as a sum in one process;
* ``route``: one ``dist.all_to_all_single`` per call, each rank sending
  the k rows of a worker's ``(W, cols)`` block that its peer's shards
  own; codes travel as int8, sidebands and gradients as float32;
* ``all_losses``: one tiled all-gather of every rank's scalar losses.
  The steps sum them in order from +0.0, so every rank sees the same
  bits; an ``all_reduce`` would add in an order of its own, and the
  non-finite check before the apply must agree on every rank.

gloo carries CPU tensors and NCCL CUDA tensors, one rank per card: NCCL
cannot put two ranks on one GPU.  A tensor on the other kind of device is
refused; nothing falls back to the in-process backend.  The collectives
keep the names torch 2.11 has (``all_gather_into_tensor``,
``reduce_scatter_tensor``), which later versions keep with a deprecation
warning.

:func:`spawn` starts R ranks with ``torch.multiprocessing``; they meet
through a ``file://`` store in a fresh temporary directory, so concurrent
jobs need no free port.  :func:`join` and :func:`leave` make or end one
rank's membership, for a caller that runs a world of one itself.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from repro_torch.core.flat_sharded import ShardedFlatLayout
from repro_torch.kernels.runtime import resolve_device

# the backend of each device type, and the device type of each backend
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}
DEVICES = {v: k for k, v in BACKENDS.items()}


def check_world(ranks: int, workers: int, device: str | torch.device
                ) -> torch.device:
    """The device type of ``ranks`` ranks holding ``workers`` workers, or
    ``ValueError`` where ``ranks`` does not divide ``workers``, and
    ``RuntimeError`` where a CUDA world has more ranks than visible
    cards."""
    if ranks < 1 or workers % ranks:
        raise ValueError(f"{ranks} ranks must divide {workers} workers")
    dev = resolve_device(torch.device(device).type)
    if dev.type == "cuda" and ranks > torch.cuda.device_count():
        raise RuntimeError(
            f"{ranks} NCCL ranks need {ranks} CUDA cards, "
            f"{torch.cuda.device_count()} visible: NCCL runs one rank per "
            f"GPU")
    return dev


class ProcessGroupBackend:
    """The step's collectives over the default process group, which must
    be initialised."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        if self.backend not in DEVICES:
            raise ValueError(f"backend {self.backend!r}: expected one of "
                             f"{sorted(DEVICES)}")
        self.device_type = DEVICES[self.backend]

    def _check(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if t.device.type != self.device_type:
                raise ValueError(
                    f"{self.backend} carries {self.device_type} tensors, "
                    f"got one on {t.device}")

    def workers(self, m: int) -> range:
        """The ``m / size`` consecutive workers, and the shards of the
        same indices, this rank holds."""
        if m % self.size:
            raise ValueError(f"{self.size} ranks must divide {m} workers")
        k = m // self.size
        return range(self.rank * k, (self.rank + 1) * k)

    def gather_flat(self, run: torch.Tensor) -> torch.Tensor:
        """The whole shard-major vector from every rank's run of it, in
        rank order, on every rank."""
        self._check(run)
        whole = run.new_empty((run.shape[0] * self.size,))
        dist.all_gather_into_tensor(whole, run.contiguous())
        return whole

    def all_gather(self, layout: ShardedFlatLayout,
                   param_flat: torch.Tensor):
        """The whole parameter tree from every rank's run of the
        shard-major vector: each leaf in its own dtype and storage."""
        self._check(param_flat)
        if param_flat.shape[0] * self.size != layout.padded_total:
            raise ValueError(f"{self.size} runs of {param_flat.shape[0]} "
                             f"elements do not make {layout.padded_total}")
        return layout.unravel(self.gather_flat(param_flat))

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's run of the sum over the ranks of their shard-major
        ``flat`` vectors: the columns of the shards it holds."""
        self._check(flat)
        if flat.shape[0] % self.size:
            raise ValueError(f"{flat.shape[0]} elements do not split over "
                             f"{self.size} ranks")
        run = flat.new_empty((flat.shape[0] // self.size,))
        dist.reduce_scatter_tensor(run, flat.contiguous())
        return run

    def worker_sum(self, terms: Iterable[tuple[list, torch.Tensor]],
                   like: list) -> list:
        """The sum over every rank's workers, in worker order from +0.0,
        of ``tensors * scale`` (``scale`` cast to each tensor's dtype),
        the same bits on every rank: ``terms`` yields this rank's
        workers' ``(tensors, scale)`` in order, and ``like`` gives each
        sum's shape and dtype.  Rank 0 adds its terms as they come; a
        later rank keeps its k terms until the sum of the ranks before it
        arrives, adds them and passes the sum on; the last rank
        broadcasts the total."""
        for x in like:
            self._check(x)
        if self.rank == 0:
            acc = [torch.zeros_like(x) for x in like]
            held = iter(terms)
        else:
            held = _drain(list(terms))
            acc = [torch.empty_like(x) for x in like]
            for a in acc:
                dist.recv(a, self.rank - 1)
        for tensors, scale in held:
            for a, t in zip(acc, tensors, strict=True):
                a.add_(t * scale.to(t.dtype))
            del tensors
        del held
        if self.rank < self.size - 1:
            for a in acc:
                dist.send(a, self.rank + 1)
        if self.size > 1:
            for a in acc:
                dist.broadcast(a, src=self.size - 1)
        return acc

    def route(self, dst: torch.Tensor, worker: int, lo: int, hi: int,
              src: torch.Tensor) -> None:
        """The ``all_to_all`` of one layer group, made by every rank for
        its ``j``-th worker at once, ``worker`` this rank's: row ``s`` of
        the ``(W, hi - lo)`` block ``src`` goes to the rank that holds
        shard ``s``, which keeps it at row ``worker``, columns ``lo:hi``
        of that shard's ``(W, cols)`` receive buffer.  ``dst`` holds this
        rank's k shards' buffers, ``(k, W, cols)``."""
        self._check(dst, src)
        k = dst.shape[0]
        j = worker - self.rank * k
        if not 0 <= j < k or src.shape[0] != self.size * k:
            raise ValueError(f"worker {worker} with a {tuple(src.shape)} "
                             f"block is not one of rank {self.rank}'s {k}")
        send = src.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # chunk p of recv: rank p's j-th worker's rows for this rank's k
        # shards; that worker is p * k + j
        dst.view(k, self.size, k, dst.shape[-1])[:, :, j, lo:hi].copy_(
            recv.view(self.size, k, -1).transpose(0, 1))

    def all_losses(self, losses: list) -> list:
        """Every rank's scalar losses, in rank order: the workers' losses
        in worker order."""
        mine = torch.stack(losses)
        self._check(mine)
        every = mine.new_empty((self.size * mine.shape[0],))
        dist.all_gather_into_tensor(every, mine)
        return list(every.unbind())


def _drain(items: list):
    """``items`` in order, each let go of as it is taken."""
    while items:
        yield items.pop(0)


def join(rank: int, ranks: int, init_method: str,
         device: str | torch.device, timeout: float | None = None,
         threads: int = 1) -> tuple[ProcessGroupBackend, torch.device]:
    """Join the ``ranks``-rank world at ``init_method`` as ``rank``: gloo
    for ``device="cpu"``, running ``threads`` intra-op threads (one by
    default, since R ranks share the host's cores; CPU matmuls round by
    thread count), NCCL on ``cuda:rank`` for ``"cuda"``.  ``timeout``
    bounds each collective (torch's default where None).  Returns the
    backend and the rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        if init_method.startswith("file://"):
            # ranks that meet through a local file share one host: NCCL
            # bootstraps over loopback unless the caller chose otherwise
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        torch.set_num_threads(threads)
    kwargs = ({} if timeout is None
              else {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            world_size=ranks, rank=rank, **kwargs)
    return ProcessGroupBackend(), dev


def leave() -> None:
    """End this process's membership of the default world."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank: int, ranks: int, init_method: str, device: str,
           timeout: float | None, threads: int, fn: Callable,
           args: tuple) -> None:
    world, dev = join(rank, ranks, init_method, device, timeout, threads)
    try:
        if rank:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                fn(world, dev, *args)
        else:
            fn(world, dev, *args)
    finally:
        leave()


def spawn(fn: Callable, ranks: int, *args, device: str = "cuda",
          timeout: float | None = None, threads: int = 1) -> None:
    """Run ``fn(world, device, *args)`` on ``ranks`` new processes, each
    one rank of a fresh world (``world`` its :class:`ProcessGroupBackend`,
    ``device`` its device: NCCL on one card a rank for ``"cuda"``, the
    default, gloo for ``"cpu"``, each gloo rank running ``threads``
    intra-op threads); only rank 0's standard output is kept.
    ``fn`` and ``args`` must pickle: ``fn`` a function of an importable
    module.  Raises when a rank raises, or, given a ``timeout``, when the
    ranks have not all ended within that many seconds; either way no rank
    is left running.  Without one it waits for the ranks however long
    they run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        check_world(ranks, ranks, dev)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(ranks, init, dev.type, timeout, threads, fn, args),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{ranks} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
