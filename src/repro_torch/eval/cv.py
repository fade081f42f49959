"""10-fold cross-validation protocol (paper §6.2.1).

Positives = the known interaction entries of one association matrix.  Each
fold hides 1/k of the positives (they are zeroed in the input network); the
solver's predicted scores for the held-out positives are compared against
all true-negative entries of that matrix.

This module is the protocol; ``scenarios.evaluate.scenario_cross_validate``
drives :func:`cross_validate` with one engine reused across every fold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import HeteroNetwork, TypePair
from repro_torch.eval.metrics import evaluate_predictions


@dataclasses.dataclass
class FoldResult:
    fold: int
    metrics: Dict[str, float]


def kfold_masks(
    R: np.ndarray,
    k: int = 10,
    seed: int = 0,
    positives: Optional[np.ndarray] = None,
) -> Iterator[np.ndarray]:
    """Yield k boolean masks over R, each hiding ~1/k of the positives.

    ``positives`` overrides the positive set (default: every nonzero
    entry).  Scenario bundles pass their *planted* truth here so noise
    edges are never treated as recoverable signal.
    """
    if positives is None:
        positives = R > 0
    elif np.any(positives & (R == 0)):
        raise ValueError("positives must be present edges (R > 0)")
    pos = np.argwhere(positives)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(pos))
    folds = np.array_split(perm, k)
    for f in folds:
        mask = np.zeros_like(R, dtype=bool)
        sel = pos[f]
        mask[sel[:, 0], sel[:, 1]] = True
        yield mask


def cross_validate(
    net: HeteroNetwork,
    pair: TypePair,
    solver_fn,
    k: int = 10,
    seed: int = 0,
    positives: Optional[np.ndarray] = None,
) -> List[FoldResult]:
    """Run k-fold CV on one association matrix.

    ``solver_fn(masked_net) -> scores`` must return the predicted score
    matrix for ``pair`` (same shape as ``net.R[pair]``).  With
    ``positives`` (a boolean subset of the present edges — e.g. a
    scenario's planted truth), folds hide only those entries and the
    negative set excludes non-positive present edges (noise), so the
    protocol runs against ground truth on any T-type scenario.
    """
    i, j = min(pair), max(pair)
    R = net.R[(i, j)]
    if positives is None:
        positives = R > 0
    results: List[FoldResult] = []
    for fold, mask in enumerate(
        kfold_masks(R, k=k, seed=seed, positives=positives)
    ):
        masked = net.with_masked_fold((i, j), mask)
        scores = solver_fn(masked)
        if scores.shape != R.shape:
            raise ValueError(
                f"solver returned {scores.shape}, expected {R.shape}"
            )
        # evaluation set: held-out positives vs all true negatives.
        # positives ⊆ (R > 0) (kfold_masks enforces it), so present
        # noise edges are excluded from the negative side automatically.
        eval_mask = mask | (R == 0)
        labels = mask[eval_mask]
        s = scores[eval_mask]
        results.append(
            FoldResult(fold=fold, metrics=evaluate_predictions(s, labels))
        )
    return results


def summarize(results: List[FoldResult]) -> Dict[str, float]:
    keys = results[0].metrics.keys()
    return {k: float(np.mean([r.metrics[k] for r in results])) for k in keys}
