"""ROC-AUC — the paper's accuracy metric for all three tasks.

A copy of ``repro.metrics.auc`` (numpy only)."""
from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (handles ties by average rank)."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    n_pos = float(labels.sum())
    n_neg = float(len(labels) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos_ranks = ranks[labels > 0.5].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class StreamingAUC:
    """Accumulate (label, score) pairs across eval batches."""

    def __init__(self):
        self._labels: list[np.ndarray] = []
        self._scores: list[np.ndarray] = []

    def update(self, labels, scores):
        self._labels.append(np.asarray(labels).reshape(-1))
        self._scores.append(np.asarray(scores).reshape(-1))

    def compute(self) -> float:
        if not self._labels:
            return 0.5
        return auc(np.concatenate(self._labels), np.concatenate(self._scores))

    def reset(self):
        self._labels.clear()
        self._scores.clear()
