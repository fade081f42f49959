"""Graph dataset generators for the GNNs.

The port's copies of ``repro.data.graphs``: ``planted_partition_graph``
(the GCN's node classification), ``molecule_batch`` (DimeNet's batched 3D
molecules) and ``mesh_rollout_batch`` (MeshGraphNet's dynamics snapshot),
each with the same numpy draws in the same order, so the same seed gives
the same arrays.  Two steps of ``planted_partition_graph`` are
reorganised for size, not for result: the same-class destination draws
group the edges by class once (one stable sort) instead of rescanning all
edges for each class, and the deduplication of ``symmetrized`` runs as
torch ops on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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


def molecule_batch(
    batch: int,
    nodes_per: int = 30,
    edges_per: int = 64,
    n_species: int = 16,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Batched random 3D molecules (a disjoint union) and planted energies."""
    rng = np.random.default_rng(seed)
    n = batch * nodes_per
    z = rng.integers(0, n_species, n).astype(np.int32)
    pos = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    src_l, dst_l = [], []
    for g in range(batch):
        off = g * nodes_per
        # a chain both ways plus random extra bonds
        a = np.arange(nodes_per - 1)
        s = np.concatenate([a, a + 1])
        d = np.concatenate([a + 1, a])
        extra = edges_per - len(s)
        if extra > 0:
            es = rng.integers(0, nodes_per, extra)
            ed = rng.integers(0, nodes_per, extra)
            s = np.concatenate([s, es])
            d = np.concatenate([d, ed])
        src_l.append(s[:edges_per] + off)
        dst_l.append(d[:edges_per] + off)
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch, dtype=np.int32), nodes_per)
    # planted target: a smooth function of species and geometry
    per_node = np.sin(z).astype(np.float32) + 0.1 * np.linalg.norm(pos, axis=-1)
    targets = np.zeros(batch, np.float32)
    np.add.at(targets, graph_ids, per_node)
    return {"z": z, "pos": pos, "src": src, "dst": dst, "graph_ids": graph_ids,
            "targets": targets}


def mesh_rollout_batch(
    n_nodes: int,
    n_edges: int,
    d_node: int = 8,
    d_edge: int = 4,
    d_out: int = 3,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """MeshGraphNet-style dynamics snapshot with a learnable local rule."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    node_feat = rng.normal(0, 1, (n_nodes, d_node)).astype(np.float32)
    edge_feat = rng.normal(0, 1, (n_edges, d_edge)).astype(np.float32)
    # target: a linear function of own and mean-neighbour features
    agg = np.zeros((n_nodes, d_node), np.float32)
    np.add.at(agg, dst, node_feat[src])
    deg = np.maximum(np.bincount(dst, minlength=n_nodes), 1)[:, None]
    w1 = rng.normal(0, 0.5, (d_node, d_out))
    w2 = rng.normal(0, 0.5, (d_node, d_out))
    targets = (node_feat @ w1 + (agg / deg) @ w2).astype(np.float32)
    return {"node_feat": node_feat, "edge_feat": edge_feat, "src": src, "dst": dst,
            "targets": targets}


__all__ = ["NodeClassificationData", "mesh_rollout_batch", "molecule_batch",
           "planted_partition_graph"]
