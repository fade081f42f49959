"""Fanout neighbour sampling (GraphSAGE-style) for minibatch GNNs.

The port's copy of ``repro.graph.sampler``: a CSR in-adjacency built once,
then per batch up to ``fanout[k]`` in-neighbours drawn uniformly (with
replacement) per frontier node at hop k, emitted as padded rectangles.
The sampler is host numpy (the input pipeline), with the same draws in
the same order as the reference, so a seed gives the same blocks.  Only
the adjacency's destination sort runs on ``device``
(:meth:`~repro_torch.graph.structures.EdgeList.sorted_by_dst`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graph.structures import EdgeList


@dataclasses.dataclass
class CSRAdjacency:
    """Compressed in-neighbour lists: neighbours of v are
    ``cols[indptr[v]:indptr[v+1]]``."""

    indptr: np.ndarray  # (N+1,) int64
    cols: np.ndarray  # (E,) int32
    num_nodes: int

    @classmethod
    def from_edgelist(cls, edges: EdgeList, device: DeviceLike = None) -> "CSRAdjacency":
        e = edges.sorted_by_dst(device)
        deg = e.in_degrees().astype(np.int64)
        indptr = np.zeros(edges.num_nodes + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        return cls(indptr=indptr, cols=e.src.copy(), num_nodes=e.num_nodes)

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        return (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)


@dataclasses.dataclass
class SampledBlock:
    """One hop of a sampled computation graph (padded).

    ``nbr[i, k]`` is the k-th sampled in-neighbour of frontier node i;
    ``mask[i, k]`` marks real (non-pad) entries.  ``nodes`` are the frontier
    ids this hop expands; the next hop's frontier is ``unique_nbrs``.
    """

    nodes: np.ndarray  # (B,) int32 frontier
    nbr: np.ndarray  # (B, fanout) int32 global ids (pad: 0)
    mask: np.ndarray  # (B, fanout) bool
    unique_nbrs: np.ndarray  # (U,) int32 next frontier


@dataclasses.dataclass
class SampledSubgraph:
    """Multi-hop sample: blocks[0] expands the seed batch, blocks[k] the
    k-th frontier.  ``all_nodes`` is the sorted union of the seeds and
    every frontier: the nodes whose features the model step gathers."""

    seeds: np.ndarray
    blocks: List[SampledBlock]
    all_nodes: np.ndarray


class NeighborSampler:
    def __init__(self, adj: CSRAdjacency, fanouts: Sequence[int], seed: int = 0):
        self.adj = adj
        self.fanouts = list(fanouts)
        self._rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        seeds = np.asarray(seeds, dtype=np.int32)
        frontier = seeds
        blocks: List[SampledBlock] = []
        seen = [seeds]
        for fanout in self.fanouts:
            nbr, mask = self._sample_hop(frontier, fanout)
            uniq = np.unique(nbr[mask]).astype(np.int32)
            blocks.append(SampledBlock(nodes=frontier, nbr=nbr, mask=mask, unique_nbrs=uniq))
            frontier = uniq
            seen.append(frontier)
        all_nodes = np.unique(np.concatenate(seen)).astype(np.int32)
        return SampledSubgraph(seeds=seeds, blocks=blocks, all_nodes=all_nodes)

    def _sample_hop(self, frontier: np.ndarray, fanout: int) -> Tuple[np.ndarray, np.ndarray]:
        b = frontier.shape[0]
        deg = self.adj.degree(frontier)  # (B,)
        # uniform with replacement when deg > 0: O(B·fanout) with fixed shapes
        draw = self._rng.integers(0, 1 << 62, size=(b, fanout))
        safe_deg = np.maximum(deg, 1)[:, None]
        offsets = (draw % safe_deg).astype(np.int64)
        starts = self.adj.indptr[frontier][:, None]
        nbr = self.adj.cols[starts + offsets].astype(np.int32)
        mask = np.broadcast_to((deg > 0)[:, None], (b, fanout)).copy()
        nbr = np.where(mask, nbr, 0)
        return nbr, mask


def relabel_to_local(
    subg: SampledSubgraph,
) -> Tuple[np.ndarray, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Map global node ids to positions in ``subg.all_nodes``.

    Returns ``(all_nodes, hops)``, each hop ``(local_frontier, local_nbr,
    mask)`` indexing the gathered feature block; pads name local node 0.
    """
    lookup = np.full(int(subg.all_nodes.max(initial=0)) + 1, -1, np.int64)
    lookup[subg.all_nodes] = np.arange(subg.all_nodes.shape[0])
    hops = []
    for blk in subg.blocks:
        hops.append(
            (
                lookup[blk.nodes].astype(np.int32),
                lookup[np.where(blk.mask, blk.nbr, subg.all_nodes[0])].astype(np.int32),
                blk.mask,
            )
        )
    return subg.all_nodes, hops


__all__ = [
    "CSRAdjacency",
    "NeighborSampler",
    "SampledBlock",
    "SampledSubgraph",
    "relabel_to_local",
]
