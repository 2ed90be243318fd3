"""Synthetic language-model token stream, in numpy.

A copy of ``repro.data.lm``: a hidden-state Markov source with
vocab-dependent emissions, deterministic per ``(seed, step)``, so both
packages draw identical batches for the same ``(seed, step)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LMStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    order_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        K = self.order_states
        # hidden-state HMM-ish source: state -> state, state -> token
        self._trans = rng.dirichlet(np.ones(K) * 0.1, size=K)
        emis = rng.dirichlet(np.ones(self.vocab_size) * 0.05, size=K)
        self._emis_cum = np.cumsum(emis, axis=1)
        self._trans_cum = np.cumsum(self._trans, axis=1)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 7_368_787 + step)
        B, S, K = self.batch_size, self.seq_len, self.order_states
        states = rng.integers(0, K, size=B)
        toks = np.empty((B, S + 1), np.int32)
        u_tok = rng.uniform(size=(B, S + 1))
        u_st = rng.uniform(size=(B, S + 1))
        for t in range(S + 1):
            toks[:, t] = (
                self._emis_cum[states] > u_tok[:, t, None]).argmax(axis=1)
            states = (self._trans_cum[states] > u_st[:, t, None]).argmax(
                axis=1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_stream(vocab_size: int, seq_len: int, batch_size: int,
                   seed: int = 0) -> LMStream:
    return LMStream(vocab_size, seq_len, batch_size, seed)
