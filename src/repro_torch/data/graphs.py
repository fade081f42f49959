"""Graph dataset generator for the GCN: planted-partition node classification.

The port's copy of ``repro.data.graphs.planted_partition_graph`` — the
same numpy draws in the same order, so the same seed gives the same
arrays.  Two steps are reorganised for size, not for result: the
same-class destination draws group the edges by class once (one stable
sort) instead of rescanning all edges for each class, and the
deduplication of ``symmetrized`` runs as torch ops on ``device``.
``molecule_batch`` and ``mesh_rollout_batch`` wait for their models.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graph.structures import EdgeList


@dataclasses.dataclass
class NodeClassificationData:
    edges: EdgeList
    feats: np.ndarray  # (N, F)
    labels: np.ndarray  # (N,)
    train_mask: np.ndarray
    n_classes: int


def planted_partition_graph(
    n_nodes: int,
    n_edges: int,
    n_classes: int,
    d_feat: int,
    homophily: float = 0.8,
    train_frac: float = 0.1,
    seed: int = 0,
    device: DeviceLike = None,
) -> NodeClassificationData:
    """Community-structured graph whose labels are recoverable from both
    features and structure; ``device`` runs the edge deduplication."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # draw dst: with prob `homophily` from the same class
    same = rng.random(n_edges) < homophily
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(n_classes + 1))
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # the same-class edges grouped by their source's class, each group in
    # edge order: the reference's ``same & (labels[src] == c)`` selections
    pos = np.flatnonzero(same)
    cls = labels[src[pos]]
    by_class = pos[np.argsort(cls, kind="stable")]
    starts = np.concatenate([[0], np.cumsum(np.bincount(cls, minlength=n_classes))])
    for c in range(n_classes):
        lo, hi = bounds[c], bounds[c + 1]
        if hi > lo:
            sel = by_class[starts[c] : starts[c + 1]]
            dst[sel] = order[rng.integers(lo, hi, int(sel.size))]
    edges = EdgeList(src=src, dst=dst, w=None, num_nodes=n_nodes).symmetrized(
        device
    ).with_self_loops()
    # features: class centroid + noise
    centroids = rng.normal(0, 1, (n_classes, d_feat))
    feats = (centroids[labels] + rng.normal(0, 1.0, (n_nodes, d_feat))).astype(np.float32)
    train_mask = rng.random(n_nodes) < train_frac
    return NodeClassificationData(
        edges=edges, feats=feats, labels=labels, train_mask=train_mask, n_classes=n_classes
    )


__all__ = ["NodeClassificationData", "planted_partition_graph"]
