"""Continuous-batching serving engine for the LM.

Counterpart of ``repro.serving.engine``: a fixed decode batch of
``num_slots`` sequences against a ``(num_slots, max_len)`` KV cache;
finished or empty slots are refilled from the waiting queue at every step
(each admission prefills the request alone and writes its cache into the
slot's rows), so decode throughput holds under ragged request lengths.

Each slot keeps its own position (``slot_pos``), so the decode step gets
a (num_slots,) position vector and runs the reference's masked attention
(``models.layers.attention_decode``), a local layer's ring addressed at
each slot's own position; the ``flash_decode`` kernel, whose position is
one scalar, serves the fixed-batch loop of ``launch.serve``.

Like the reference's engine, it prefills and decodes without a memory:
in llama-3.2-vision-11b and seamless-m4t-medium a ``cross`` layer's
cross-attention then runs as a second causal self-attention (see
``models.transformer``).

The engine takes its weights from a :class:`ParamSource`
(``serving.sources``) and pins exactly one snapshot per decode step:
``_sync`` adopts the newest snapshot at the step boundary, so a live sync
landing mid-step never mixes versions inside one forward pass.  KV already
in a slot's cache was computed under the version current at its step.

The cache is written in place: admission copies the prefilled rows into
the slot's rows of every leaf, and each decode step writes one position a
slot (a slot whose position has reached ``max_len`` writes nothing, as the
reference's ``mode="drop"`` scatter drops it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.sources import ParamSource, StaticSource


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    eos_id: int = -1                   # -1: only length-terminated
    # filled by the engine:
    output: list = field(default_factory=list)
    admitted_at_step: int = -1
    finished: bool = False


def _slot_assign(cache_tree: Any, slot_cache: Any, slot: int) -> None:
    """Write ``slot_cache`` (a batch-1 cache tree) into ``cache_tree`` at
    slot index ``slot``, in place, walking its dicts and lists (the
    ``prefix`` layers' caches).  Stacked leaves ``(repeats, B, ...)`` take
    ``(repeats, 1, ...)`` into ``[:, slot]``, plain ``(B, ...)`` leaves
    ``(1, ...)`` into ``[slot]`` (a Mamba2 mixer's state and conv window
    are stacked leaves like k and v); scalars and leaves of another rank
    (the engine-owned position) are left alone."""
    if isinstance(cache_tree, dict):
        for key, full in cache_tree.items():
            if key in slot_cache:
                _slot_assign(full, slot_cache[key], slot)
        return
    if isinstance(cache_tree, list):
        for full, one in zip(cache_tree, slot_cache, strict=True):
            _slot_assign(full, one, slot)
        return
    full, one = cache_tree, slot_cache
    if full.dim() == 0 or one is None or one.dim() != full.dim():
        return
    if one.shape == full.shape:          # an engine of one slot
        full.copy_(one)
    elif full.dim() >= 2 and one.shape[0] == full.shape[0] \
            and full.shape[1] != one.shape[1]:
        full[:, slot:slot + 1] = one.to(full.dtype)
    else:
        full[slot:slot + 1] = one.to(full.dtype)


class ServingEngine:
    """Greedy-decoding continuous-batching engine.

    ``source`` is a :class:`~repro_torch.serving.sources.ParamSource`; a
    raw params tree is also accepted (wrapped in a StaticSource).
    ``config`` supplies the engine knobs; the ``num_slots``/``max_len``
    arguments override it.  The cache lives on the device of the
    parameters' ``embed``."""

    def __init__(self, source: ParamSource | Any, cfg: ModelConfig, *,
                 config: ServingConfig | None = None,
                 num_slots: int | None = None,
                 max_len: int | None = None):
        if not isinstance(source, ParamSource):
            source = StaticSource(source)
        self.source = source
        self.config = config or ServingConfig()
        self.cfg = cfg
        self.num_slots = (num_slots if num_slots is not None
                          else self.config.num_slots)
        self.max_len = max_len if max_len is not None else self.config.max_len
        snap = source.snapshot()
        self.params = snap.params
        self.param_version = snap.version
        self.param_step = snap.step
        self.syncs_adopted = 0
        self.clamped_requests = 0
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * self.num_slots
        self.completed: list[Request] = []
        self.steps = 0
        self.decode_tokens = 0
        self.device = self.params["embed"].device
        self.cache = T.init_cache(cfg, self.num_slots, self.max_len,
                                  self.device)
        # per-slot positions (the cache's scalar pos is replaced by these)
        self.slot_pos = np.zeros(self.num_slots, np.int64)
        self.slot_remaining = np.zeros(self.num_slots, np.int64)
        self.tokens = torch.zeros((self.num_slots, 1), dtype=torch.int32,
                                  device=self.device)

    # -- param sync --------------------------------------------------------

    def _sync(self) -> None:
        """Adopt the newest snapshot at a step boundary.  ``snapshot()``
        never blocks, so the decode loop never waits on the sync thread."""
        snap = self.source.snapshot()
        if snap.version != self.param_version:
            self.params = snap.params
            self.param_version = snap.version
            self.param_step = snap.step
            self.syncs_adopted += 1

    def close(self, grace: float = 1.0) -> None:
        self.source.close(grace)

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(req.prompt)} tokens does not "
                             f"fit a cache of {self.max_len}")
        # the slot writes cache position len(prompt) + k at decode step k:
        # clamp the budget so that every write stays inside the cache
        budget = self.max_len - len(req.prompt)
        if req.max_new_tokens > budget:
            req.max_new_tokens = budget
            self.clamped_requests += 1
        self.queue.append(req)

    def _admit(self, slot: int, req: Request) -> None:
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        logits, slot_cache = T.prefill(self.params, self.cfg, prompt,
                                       cache_len=self.max_len)
        _slot_assign(self.cache, slot_cache, slot)
        first = int(torch.argmax(logits[0]))
        req.output.append(first)
        req.admitted_at_step = self.steps
        self.active[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_remaining[slot] = req.max_new_tokens - 1
        self.tokens[slot, 0] = first

    # -- stepping ----------------------------------------------------------

    def _refill(self) -> None:
        for slot in range(self.num_slots):
            if self.active[slot] is None and self.queue:
                self._admit(slot, self.queue.pop(0))

    def step(self) -> int:
        """One decode step over all occupied slots; returns #active."""
        self._sync()        # pin ONE snapshot version for this whole step
        self._refill()      # prefills run under the same pinned version
        occupied = [s for s in range(self.num_slots)
                    if self.active[s] is not None]
        if not occupied:
            return 0
        cache = {**self.cache, "pos": torch.as_tensor(
            self.slot_pos.astype(np.int32), device=self.device)}
        logits, cache = T.decode_step(self.params, self.cfg, self.tokens,
                                      cache)
        self.cache = cache
        self.steps += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for slot in occupied:
            req = self.active[slot]
            tok = int(nxt[slot])
            req.output.append(tok)
            self.decode_tokens += 1
            self.slot_pos[slot] += 1
            self.slot_remaining[slot] -= 1
            if (self.slot_remaining[slot] <= 0
                    or (req.eos_id >= 0 and tok == req.eos_id)):
                req.finished = True
                self.completed.append(req)
                self.active[slot] = None
            else:
                self.tokens[slot, 0] = tok
        return len([s for s in self.active if s is not None])

    def run(self, max_steps: int = 10_000) -> dict:
        t0 = time.perf_counter()
        while (self.queue or any(self.active)) and self.steps < max_steps:
            self.step()
        dt = time.perf_counter() - t0
        return {
            "completed": len(self.completed),
            "decode_steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "tokens_per_s": self.decode_tokens / dt if dt else 0.0,
            "slot_utilization": (self.decode_tokens
                                 / max(1, self.steps * self.num_slots)),
            "param_version": self.param_version,
            "param_step": self.param_step,
            "syncs_adopted": self.syncs_adopted,
            "clamped_requests": self.clamped_requests,
        }
