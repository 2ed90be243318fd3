"""Schedule-replay trainer: parameter-server training semantics in PyTorch.

Counterpart of ``repro.core.trainer``.  ``repro_torch.sim.cluster.simulate``
turns a cluster scenario and a training mode into a :class:`Schedule`; this
module replays it with real gradients: the gradient of every slot is taken
against the parameter version of its ``dispatch_step`` (a ring of recent
versions), then aggregated with the mode's rule: GBA's token decay and
per-ID embedding treatment, BSP's plain mean, Hop-BW's drop-slowest,
async's immediate apply.

Each global step stacks the M slot batches and takes the per-slot
gradients in one ``torch.func.vmap`` of ``grad_and_value`` (over stacked
parameter versions, or over the batches alone when every slot was
dispatched at the same version).  The per-slot contributor counts of the
sparse module (Alg. 2 line 23) come from ``presence_counts``, which is
the ``embedding_bag_grad`` kernel's counts output, taken from the raw ids
with no sort: slot i's ids are offset by ``i * capacity``, so one launch
per global step counts all M slots.
The JAX trainer takes that route when ``embed_stream`` is set, and its
tests show it equals its one-hot default; the port has no other route.
The kernel is launched outside the ``vmap``: a ctypes launch cannot run
under ``torch.func`` transforms.

Parameters are never updated in place.  The version ring holds earlier
parameter dicts by reference, so every update makes new tensors.

On a CUDA device every global step synchronises once, to read the slot
losses and the rescued count, as the JAX trainer does.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.recsys import RecsysConfig
from repro_torch.data.clickstream import ClickStream
from repro_torch.embeddings.table import presence_counts
from repro_torch.metrics.auc import StreamingAUC
from repro_torch.models import recsys as R
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map
from repro_torch.sim.cluster import Schedule

Params = Any

EMBED_KEYS = ("embed", "linear")   # the sparse module


@dataclass
class ReplayStats:
    applied_steps: int = 0
    kept_slots: int = 0
    dropped_slots: int = 0
    history_clamps: int = 0
    embed_rows_rescued: int = 0     # per-ID relaxation kept a stale slot's row
    losses: list[float] = field(default_factory=list)
    # host-clock seconds: drawing and stacking the slot batches, and the
    # global steps (each ends in a synchronising read of its losses)
    data_s: float = 0.0
    step_s: float = 0.0


class VersionRing:
    """Last-H parameter versions for delayed-gradient computation."""

    def __init__(self, history: int):
        self._h = history
        self._ring: collections.OrderedDict[int, Params] = \
            collections.OrderedDict()

    def put(self, version: int, params: Params):
        self._ring[version] = params
        while len(self._ring) > self._h:
            self._ring.popitem(last=False)

    def get(self, version: int) -> tuple[Params, bool]:
        if version in self._ring:
            return self._ring[version], False
        oldest = next(iter(self._ring))
        return self._ring[oldest], True


def _split_tree(grads: Params) -> tuple[Params, Params]:
    sparse = {k: v for k, v in grads.items() if k in EMBED_KEYS}
    dense = {k: v for k, v in grads.items() if k not in EMBED_KEYS}
    return sparse, dense


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


@dataclass
class GBATrainer:
    cfg: RecsysConfig
    optimizer: Optimizer
    iota: int = 4
    per_id_embedding_decay: bool = True   # Alg. 2 lines 21/23
    history: int = 64

    def __post_init__(self):
        self._grad_fn = grad_and_value(
            lambda p, b: R.bce_loss(p, self.cfg, b))

    # -- one global step ------------------------------------------------------

    def _flat_ids(self, batches: dict, m: int) -> torch.Tensor:
        """All hashed IDs each slot touched: (M, n_ids)."""
        parts = [batches["fields"].reshape(m, -1)]
        if "behavior" in batches:
            parts.append(batches["behavior"].reshape(m, -1))
            parts.append(batches["target"].reshape(m, -1))
        return torch.cat(parts, dim=1)

    def _step(self, gba: bool, shared_src: bool, src_params, params,
              opt_state, batches, tokens, weights, step_k: int,
              last_update):
        """One global step: per-slot gradients, the mode's aggregate, the
        optimizer update and the ``last_update`` stamp.  Returns
        ``(params, opt_state, last_update, losses (M,), rescued)``."""
        m = tokens.shape[0]
        cap = self.cfg.hash_capacity
        in_dims = (None, 0) if shared_src else (0, 0)
        grads, losses = vmap(self._grad_fn, in_dims=in_dims)(
            src_params, batches)
        sparse_g, dense_g = _split_tree(grads)

        # dense module: Alg. 2 line 22, weighted sum / N_a (= m)
        wm = (weights / m).float()
        agg = tree_map(
            lambda g: torch.tensordot(wm, g.float(), dims=([0], [0]))
            .to(g.dtype), dense_g)

        # sparse module: per-ID treatment (Alg. 2 lines 21/23).  Offsetting
        # slot i's ids by i*cap turns the M per-slot histograms into one
        # kernel launch over an (M*cap)-row id space
        ids_all = self._flat_ids(batches, m)
        slot_offset = (torch.arange(m, dtype=torch.int32,
                                    device=ids_all.device) * cap)[:, None]
        present = presence_counts(ids_all + slot_offset,
                                  m * cap).reshape(m, cap)
        touched01 = (present > 0).float()                       # (M, cap)
        rescued = torch.zeros((), dtype=torch.int64)
        if gba:
            # per-ID relaxation: a slot dropped by Eq.(1) may still
            # contribute rows whose IDs were untouched since its token
            slot_ok = (step_k - tokens) <= self.iota            # (M,)
            id_fresh = last_update[None, :] <= tokens[:, None]
            keep_row = torch.where(slot_ok[:, None], 1.0, id_fresh.float())
            row_mask = touched01 * keep_row                     # (M, cap)
            rescued = ((~slot_ok) & (row_mask.sum(dim=1) > 0)).sum()
            emb_num = {
                name: torch.sum(g * (row_mask[..., None] if g.dim() == 3
                                     else row_mask), dim=0)
                for name, g in sparse_g.items()
            }
            emb_cnt = row_mask.sum(dim=0)
        else:
            # same denominator semantics as the GBA path: an ID's
            # contributor count is the number of SLOTS that touched it
            # (Alg. 2 line 23), not its occurrence count
            emb_num = {name: torch.tensordot(weights, g, dims=([0], [0]))
                       for name, g in sparse_g.items()}
            emb_cnt = (touched01 * weights[:, None]).sum(dim=0)

        # embedding aggregate: divide by #slots that touched the ID
        # (Alg. 2 line 23); baselines divide by the same rule for parity
        full_grads = dict(agg)
        cntc = torch.clamp_min(emb_cnt, 1.0)
        for name, g in emb_num.items():
            full_grads[name] = g / (cntc[:, None] if g.dim() > 1 else cntc)
        params, opt_state = self.optimizer.update(params, full_grads,
                                                  opt_state)
        if sparse_g:
            last_update = torch.where(emb_cnt > 0, step_k, last_update)
        return params, opt_state, last_update, losses, rescued

    # -- schedule replay ------------------------------------------------------

    def replay(self, params: Params, opt_state: Any, schedule: Schedule,
               stream: ClickStream, day: int, *,
               last_update: torch.Tensor | None = None,
               stats: ReplayStats | None = None):
        """Replay one day's schedule on the device of ``params``.  Returns
        (params, opt_state, last_update, stats)."""
        stats = stats or ReplayStats()
        device = next(tree_leaves(params)).device
        if last_update is None:
            last_update = torch.zeros((self.cfg.hash_capacity,),
                                      dtype=torch.int32, device=device)
        ring = VersionRing(self.history)
        gba = schedule.mode == "gba" and self.per_id_embedding_decay

        for k, slots in enumerate(schedule.steps):
            t0 = time.perf_counter()
            ring.put(k, params)
            srcs = []
            for slot in slots:
                src, clamped = ring.get(slot.dispatch_step)
                stats.history_clamps += int(clamped)
                srcs.append(src)
            shared_src = all(s.dispatch_step == slots[0].dispatch_step
                             for s in slots)
            if shared_src:
                src_params = srcs[0]
            else:
                src_params = tree_map(lambda *xs: torch.stack(xs), *srcs)
            raw = [stream.batch(day, slot.batch_index) for slot in slots]
            batches = _to_device({key: np.stack([b[key] for b in raw])
                                  for key in raw[0]}, device)
            tokens = torch.tensor([s.token for s in slots],
                                  dtype=torch.int32, device=device)
            weights = torch.tensor([s.weight for s in slots],
                                   dtype=torch.float32, device=device)
            t1 = time.perf_counter()
            params, opt_state, last_update, losses, rescued = self._step(
                gba, shared_src, src_params, params, opt_state, batches,
                tokens, weights, k, last_update)
            for slot in slots:
                if slot.weight > 0:
                    stats.kept_slots += 1
                else:
                    stats.dropped_slots += 1
            stats.embed_rows_rescued += int(rescued)
            stats.applied_steps += 1
            stats.losses.append(float(losses.mean()))
            stats.data_s += t1 - t0
            stats.step_s += time.perf_counter() - t1
        return params, opt_state, last_update, stats


def evaluate(params: Params, cfg: RecsysConfig, stream: ClickStream,
             day: int, num_batches: int = 16) -> float:
    """AUC of the model on ``num_batches`` held-out batches of ``day``."""
    device = next(tree_leaves(params)).device
    sauc = StreamingAUC()
    with torch.no_grad():
        for i in range(num_batches):
            batch = stream.batch(day, 10_000 + i)
            logit = R.recsys_logit(params, cfg, _to_device(batch, device))
            sauc.update(batch["label"], logit.cpu().numpy())
    return sauc.compute()
