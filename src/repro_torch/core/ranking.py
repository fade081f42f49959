"""Output stage (paper workflow steps E–G, Fig. 2).

From the converged label matrix ``F (N, N)`` (all-sources run) we produce:
  1. the *first output*: predicted interaction matrices per type pair,
  2. the *second output*: updated similarity matrices per type,
  3. the *final output*: per-entity sorted candidate lists (step G).

The paper symmetrizes mutual labels in the last superstep
("the vertices carry out mean operation for their mutual labels"):
``out(u, v) = (F[u, v] + F[v, u]) / 2``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import NormalizedNetwork, TypePair


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


def symmetrize(F: np.ndarray) -> np.ndarray:
    if F.shape[0] != F.shape[1]:
        raise ValueError(
            "symmetrization needs the all-sources (square) label matrix; "
            f"got {F.shape}"
        )
    return (F + F.T) / 2.0


def extract_outputs(F: np.ndarray, norm: NormalizedNetwork) -> LPOutputs:
    out = symmetrize(F)
    sl = norm.block_slices()
    sims = [out[sl[i], sl[i]].copy() for i in range(norm.num_types)]
    inters: Dict[TypePair, np.ndarray] = {}
    for i in range(norm.num_types):
        for j in range(i + 1, norm.num_types):
            inters[(i, j)] = out[sl[i], sl[j]].copy()
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
    """
    scores = np.asarray(scores, dtype=np.float64)
    if scores.ndim != 1:
        raise ValueError(f"scores must be 1-D, got {scores.shape}")
    keep = np.ones(scores.shape[0], dtype=bool)
    if exclude is not None:
        exclude = np.asarray(exclude)
        if exclude.dtype == bool:
            if exclude.shape != scores.shape:
                raise ValueError(
                    f"boolean exclude shape {exclude.shape} != {scores.shape}"
                )
            keep &= ~exclude
        elif exclude.size:
            keep[exclude.astype(np.int64)] = False
    candidates = np.nonzero(keep)[0]
    order = np.argsort(-scores[candidates], kind="stable")
    return candidates[order[:top_k]]


def rank_of(scores: np.ndarray, index: int) -> int:
    """1-based rank of ``index`` under descending score (ties: stable)."""
    order = np.argsort(-scores, kind="stable")
    return int(np.where(order == index)[0][0]) + 1
