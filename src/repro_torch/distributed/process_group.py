"""The collectives of the worker-parallel PS step over ``torch.distributed``
ranks.

Counterpart of the ``lax`` collectives that
``repro.core.gba_shard_map.make_gba_fused_psum_step`` issues along the
mesh's ``data`` axis, where every device is one worker and one PS shard.
Here R ranks hold W workers, W divisible by R: rank ``r`` holds the k = W
/ R consecutive workers ``r * k ... r * k + k - 1`` and the shards of the
same indices.  It keeps only their part of the state: the ``(k *
shard_size,)`` run of the shard-major ``param_flat`` and accumulator that
starts at column ``r * k * shard_size``, and its workers' ``(k,
padded_total)`` wire rows.  :class:`ProcessGroupBackend` offers the four
functions of ``repro_torch.distributed.inprocess``:

* ``all_gather``: one tiled all-gather of the ranks' runs into the whole
  ``(padded_total,)`` vector, which is then unraveled;
* ``route``: one ``dist.all_to_all_single`` per call, each rank sending
  the k rows of a worker's ``(W, cols)`` block that its peer's shards
  own; codes travel as int8, sidebands and gradients as float32;
* ``all_losses``: one tiled all-gather of the k losses.
  The step sums them in worker order from +0.0, so every rank sees the
  same bits; an ``all_reduce`` would add in an order of its own, and the
  non-finite check before the apply must agree on every rank.

gloo carries CPU tensors and NCCL CUDA tensors, one rank per card: NCCL
cannot put two ranks on one GPU.  A tensor on the other kind of device is
refused; nothing falls back to the in-process backend.

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
from typing import Callable

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

    def all_gather(self, layout: ShardedFlatLayout,
                   param_flat: torch.Tensor):
        """The whole parameter tree from every rank's run of the
        shard-major vector: each leaf in its own dtype and storage."""
        self._check(param_flat)
        if param_flat.shape[0] * self.size != layout.padded_total:
            raise ValueError(f"{self.size} runs of {param_flat.shape[0]} "
                             f"elements do not make {layout.padded_total}")
        whole = param_flat.new_empty((layout.padded_total,))
        dist.all_gather_into_tensor(whole, param_flat.contiguous())
        return layout.unravel(whole)

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
        """Every rank's workers' scalar losses, in worker order."""
        mine = torch.stack(losses)
        self._check(mine)
        every = mine.new_empty((self.size * mine.shape[0],))
        dist.all_gather_into_tensor(every, mine)
        return list(every.unbind())


def join(rank: int, ranks: int, init_method: str,
         device: str | torch.device, timeout: float | None = None
         ) -> tuple[ProcessGroupBackend, torch.device]:
    """Join the ``ranks``-rank world at ``init_method`` as ``rank``: gloo
    for ``device="cpu"`` (one thread, since R ranks share the host's
    cores), NCCL on ``cuda:rank`` for ``"cuda"``.  ``timeout`` bounds each
    collective (torch's default where None).  Returns the backend and the
    rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        if init_method.startswith("file://"):
            # ranks that meet through a local file share one host: NCCL
            # bootstraps over loopback unless the caller chose otherwise
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    else:
        torch.set_num_threads(1)
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
           timeout: float | None, fn: Callable, args: tuple) -> None:
    world, dev = join(rank, ranks, init_method, device, timeout)
    try:
        if rank:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                fn(world, dev, *args)
        else:
            fn(world, dev, *args)
    finally:
        leave()


def spawn(fn: Callable, ranks: int, *args, device: str = "cpu",
          timeout: float | None = None) -> None:
    """Run ``fn(world, device, *args)`` on ``ranks`` new processes, each
    one rank of a fresh world (``world`` its :class:`ProcessGroupBackend`,
    ``device`` its device); only rank 0's standard output is kept.
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
            _entry, args=(ranks, init, dev.type, timeout, fn, args),
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
