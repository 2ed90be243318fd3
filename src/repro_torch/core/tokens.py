"""The paper's token list (Sec. 4.1).

Counterpart of ``repro.core.tokens``.  Given a dataset of Q batches and
buffer size M, the token list holds Q tokens in ascending order with each
value repeated M times, so the i-th dispatched batch carries ``t_i =
floor(i / M)``: the global step it is *scheduled* to be aggregated at, and
the reference point for data staleness.

The paper's text writes ``t_i = floor(i / K)`` with ``K = ceil(Q/M)``;
that formula contradicts its own constraints (each token value repeats M
times, tokens ascend, values in 0..K-1), and ``floor(i / M)`` is the one
assignment that satisfies them, as the reference records.
"""
from __future__ import annotations

import math

import torch


def num_global_steps(num_batches: int, buffer_size: int) -> int:
    """K = ceil(Q / M)."""
    return math.ceil(num_batches / buffer_size)


def token_for_batch(batch_index, buffer_size: int):
    """t_i = floor(i / M); works on ints, numpy arrays and tensors."""
    return batch_index // buffer_size


def token_list(num_batches: int, buffer_size: int) -> torch.Tensor:
    """The Q tokens as an int32 tensor on the CPU."""
    return torch.arange(num_batches, dtype=torch.int32) // buffer_size


class TokenListExhausted(IndexError):
    """Raised by :meth:`TokenList.fetch` past the last token.

    Deliberately not ``StopIteration``: PEP 479 turns a ``StopIteration``
    that escapes a generator frame into ``RuntimeError``, so a
    generator-based dispatch loop draining a TokenList could never catch
    the exhaustion under its own name.  A fetch past the end is an
    out-of-range access, so ``except IndexError`` works too."""


class TokenList:
    """Stateful FIFO view used by the PS side of the simulator and trainer:
    Algorithm 2's token-generation thread yields tokens in ascending
    order, one per pull request."""

    def __init__(self, num_batches: int, buffer_size: int):
        self._next = 0
        self._num_batches = num_batches
        self._m = buffer_size

    def fetch(self) -> int:
        if self._next >= self._num_batches:
            raise TokenListExhausted(
                f"token list exhausted after {self._num_batches} fetches")
        tok = self._next // self._m
        self._next += 1
        return tok

    @property
    def remaining(self) -> int:
        return self._num_batches - self._next
