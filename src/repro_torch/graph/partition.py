"""Graph partitioning for the distributed engines.

The port's copy of ``repro.graph.partition`` (host numpy, the same arrays):

* ``edge_partition`` splits the COO edge list into ``k`` equal shards,
  destination-contiguous (the sort on ``device``), padded with zero-weight
  self-loops on node 0;
* ``node_partition`` gives contiguous row bands of nodes per shard;
* ``balance_report`` is the edge balance of a node partition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graph.structures import EdgeList


@dataclasses.dataclass
class EdgeShards:
    """(k, E/k) stacked shards; pads are zero-weight self-loops on node 0."""

    src: np.ndarray  # (k, Ep) int32
    dst: np.ndarray  # (k, Ep) int32
    w: np.ndarray  # (k, Ep) float32
    num_nodes: int

    @property
    def num_shards(self) -> int:
        return int(self.src.shape[0])

    @property
    def edges_per_shard(self) -> int:
        return int(self.src.shape[1])


def edge_partition(edges: EdgeList, k: int, device: DeviceLike = None) -> EdgeShards:
    e = edges.sorted_by_dst(device)
    per = max((e.num_edges + k - 1) // k, 1)
    pad = per * k - e.num_edges
    src = np.concatenate([e.src, np.zeros(pad, np.int32)])
    dst = np.concatenate([e.dst, np.zeros(pad, np.int32)])
    w = np.concatenate([e.weights(), np.zeros(pad, np.float32)])
    return EdgeShards(
        src=src.reshape(k, per), dst=dst.reshape(k, per), w=w.reshape(k, per),
        num_nodes=e.num_nodes,
    )


@dataclasses.dataclass
class NodeBands:
    """Contiguous row bands: shard i owns rows [bounds[i], bounds[i+1])."""

    bounds: np.ndarray  # (k+1,) int64
    num_nodes: int

    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.bounds, nodes, side="right") - 1).astype(np.int32)


def node_partition(num_nodes: int, k: int) -> NodeBands:
    per = (num_nodes + k - 1) // k
    bounds = np.minimum(np.arange(k + 1, dtype=np.int64) * per, num_nodes)
    return NodeBands(bounds=bounds, num_nodes=num_nodes)


def balance_report(edges: EdgeList, k: int) -> Tuple[float, List[int]]:
    """Edge balance of a node partition (a straggler predictor): the
    max/mean load ratio and the per-shard edge counts."""
    bands = node_partition(edges.num_nodes, k)
    owner = bands.owner_of(edges.dst)
    counts = np.bincount(owner, minlength=k).tolist()
    mean = max(1.0, edges.num_edges / k)
    return max(counts) / mean, counts


__all__ = ["EdgeShards", "NodeBands", "balance_report", "edge_partition", "node_partition"]
