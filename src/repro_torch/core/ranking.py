"""Output stage (paper workflow steps E–G, Fig. 2).

From the converged label matrix ``F (N, N)`` (all-sources run) we produce:
  1. the *first output*: predicted interaction matrices per type pair,
  2. the *second output*: updated similarity matrices per type,
  3. the *final output*: per-entity sorted candidate lists (step G).

The paper symmetrizes mutual labels in the last superstep
("the vertices carry out mean operation for their mutual labels"):
``out(u, v) = (F[u, v] + F[v, u]) / 2``.

:func:`extract_outputs` runs inside an ``lp.extract`` span and each
:func:`topk_exclusive` call inside an ``lp.topk`` span
(:func:`repro_torch.obs.profiler.hot_span`); with a collector installed,
each :func:`topk_exclusive` call also counts ``rank.topk.select`` or
``rank.topk.full_sort``, the path it took.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import NormalizedNetwork, TypePair
from repro_torch.obs import profiler
from repro_torch.obs.profiler import hot_span


@dataclasses.dataclass
class LPOutputs:
    similarities: List[np.ndarray]  # per type: (n_i, n_i)
    interactions: Dict[TypePair, np.ndarray]  # per pair (i<j): (n_i, n_j)

    def ranked_candidates(
        self, pair: TypePair, entity: int, top_k: int = 20
    ) -> np.ndarray:
        """Top-k entities of type ``pair[1]`` for ``entity`` of ``pair[0]``.

        The paper's step G: e.g. for the drug-target matrix, the targets are
        sorted per drug by similarity degree (Tables 3/4).
        """
        i, j = pair
        if (i, j) in self.interactions:
            row = self.interactions[(i, j)][entity]
        elif (j, i) in self.interactions:
            row = self.interactions[(j, i)][:, entity]
        else:
            raise KeyError(f"no interaction block for {pair}")
        order = np.argsort(-row, kind="stable")
        return order[:top_k]


def _check_square(F: np.ndarray) -> None:
    if F.shape[0] != F.shape[1]:
        raise ValueError(
            "symmetrization needs the all-sources (square) label matrix; "
            f"got {F.shape}"
        )


def symmetrize(F: np.ndarray) -> np.ndarray:
    _check_square(F)
    return (F + F.T) / 2.0


def _mutual_mean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``(a + b.T) / 2`` into a fresh array, value for value as
    :func:`symmetrize` gives it: numpy's blocked transpose copy of ``b``,
    then the sum and the halving in place (× 0.5 is / 2 exactly)."""
    out = b.T.copy()
    np.add(a, out, out=out)
    out *= 0.5
    return out


def extract_outputs(F: np.ndarray, norm: NormalizedNetwork) -> LPOutputs:
    """Every type's similarity block and every pair's interaction block of
    the symmetrized ``F``, each built from its two mirror blocks of ``F``
    alone: nothing of size ``(N, N)`` is allocated."""
    with hot_span("lp.extract"):
        _check_square(F)
        sl = norm.block_slices()
        sims = [_mutual_mean(F[s, s], F[s, s]) for s in sl]
        inters: Dict[TypePair, np.ndarray] = {}
        for i in range(norm.num_types):
            for j in range(i + 1, norm.num_types):
                inters[(i, j)] = _mutual_mean(F[sl[i], sl[j]], F[sl[j], sl[i]])
        return LPOutputs(similarities=sims, interactions=inters)


def topk_exclusive(
    scores: np.ndarray,
    top_k: int,
    exclude: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Indices of the ``top_k`` highest scores, skipping ``exclude``.

    The serving front-end's ranking step: candidate lists for drug
    repositioning must *exclude* the already-known associations (they would
    trivially top the list — the paper's Tables 3/4 rank the held-out /
    novel candidates).  ``exclude`` is an index array or boolean mask over
    ``scores``; ties break stably by index like :func:`rank_of`.

    The answer is the first ``top_k`` of the stable descending sort of the
    kept scores (NaN last), found by selection where that is exact: the
    excluded scores become -inf on a copy, ``np.partition`` finds the
    ``top_k``-th best score ``cut``, and only the indices scoring
    ``>= cut``, ties at the cut included, are sorted by (-score, index).
    That holds when ``cut > -inf`` (no excluded index reaches the cut) and
    at least ``top_k`` indices reach it (no NaN, which a partition ranks
    highest, took a place).  Otherwise (``top_k`` not below the kept
    count, a NaN among the best, a kept -inf at the cut) the whole kept
    row is sorted.
    """
    with hot_span("lp.topk"):
        scores = np.asarray(scores, dtype=np.float64)
        if scores.ndim != 1:
            raise ValueError(f"scores must be 1-D, got {scores.shape}")
        n = scores.shape[0]
        masked = scores
        if exclude is not None:
            exclude = np.asarray(exclude)
            if exclude.dtype == bool:
                if exclude.shape != scores.shape:
                    raise ValueError(
                        f"boolean exclude shape {exclude.shape} != {scores.shape}"
                    )
            elif exclude.size:
                exclude = exclude.astype(np.int64)
            else:
                exclude = None
            if exclude is not None:
                masked = scores.copy()
                masked[exclude] = -np.inf
        if 0 < top_k < n:
            cut = np.partition(masked, n - top_k)[n - top_k]
            if cut > -np.inf:
                top = np.flatnonzero(masked >= cut)
                if top.size >= top_k:
                    tel = profiler._COLLECTOR
                    if tel is not None:
                        tel.count("rank.topk.select")
                    return top[np.argsort(-masked[top], kind="stable")[:top_k]]
        tel = profiler._COLLECTOR
        if tel is not None:
            tel.count("rank.topk.full_sort")
        keep = np.ones(n, dtype=bool)
        if exclude is not None:
            keep[exclude] = False
        candidates = np.nonzero(keep)[0]
        order = np.argsort(-scores[candidates], kind="stable")
        return candidates[order[:top_k]]


def rank_of(scores: np.ndarray, index: int) -> int:
    """1-based rank of ``index`` under descending score (ties: stable)."""
    order = np.argsort(-scores, kind="stable")
    return int(np.where(order == index)[0][0]) + 1
