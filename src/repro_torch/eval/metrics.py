"""Prediction-accuracy metrics (paper §6.2): AUC, AUPR, BestACC.

Numpy implementations (host-side evaluation of LP outputs), matching the
standard definitions used in the drug-repositioning literature.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _validate(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    if scores.shape != labels.shape:
        raise ValueError("scores/labels shape mismatch")
    if labels.all() or (~labels).all():
        raise ValueError("need at least one positive and one negative")
    return scores, labels


def auc_score(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve via the Mann–Whitney rank statistic
    (tie-aware: ties get average ranks)."""
    scores, labels = _validate(scores, labels)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, len(scores) + 1, dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j + 2) / 2.0
            ranks[order[i : j + 1]] = avg
        i = j + 1
    npos = int(labels.sum())
    nneg = len(labels) - npos
    rank_sum = ranks[labels].sum()
    return float((rank_sum - npos * (npos + 1) / 2.0) / (npos * nneg))


def aupr_score(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the precision-recall curve (step-wise interpolation, i.e.
    average precision)."""
    scores, labels = _validate(scores, labels)
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    tp = np.cumsum(labels)
    k = np.arange(1, len(labels) + 1)
    precision = tp / k
    npos = tp[-1]
    # AP = Σ precision@k · Δrecall@k  (Δrecall nonzero only at positives)
    return float((precision * labels).sum() / npos)


def best_accuracy(scores: np.ndarray, labels: np.ndarray) -> float:
    """Max over all decision thresholds of (TP+TN)/(P+N) — the paper's
    BestACC."""
    scores, labels = _validate(scores, labels)
    order = np.argsort(-scores, kind="mergesort")
    labels_sorted = labels[order]
    npos = int(labels.sum())
    nneg = len(labels) - npos
    # predict positive for top-k as k sweeps 0..n
    tp = np.concatenate([[0], np.cumsum(labels_sorted)])
    fp = np.arange(len(labels) + 1) - tp
    tn = nneg - fp
    acc = (tp + tn) / len(labels)
    return float(acc.max())


def evaluate_predictions(
    scores: np.ndarray, labels: np.ndarray
) -> dict:
    return {
        "auc": auc_score(scores, labels),
        "aupr": aupr_score(scores, labels),
        "best_acc": best_accuracy(scores, labels),
    }
