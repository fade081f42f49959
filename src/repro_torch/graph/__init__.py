"""Graph substrate: structures, generators, segment ops, sampling and
partitioning."""

from repro_torch.graph.partition import (
    EdgeShards,
    NodeBands,
    balance_report,
    edge_partition,
    node_partition,
)
from repro_torch.graph.sampler import (
    CSRAdjacency,
    NeighborSampler,
    SampledBlock,
    SampledSubgraph,
    relabel_to_local,
)
from repro_torch.graph.segment import (
    degree,
    gcn_norm,
    scatter_spmm,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from repro_torch.graph.structures import (
    EdgeList,
    PaddedCSR,
    erdos_renyi,
    padded_csr_tensors,
    powerlaw_graph,
)

__all__ = [
    "CSRAdjacency",
    "EdgeList",
    "EdgeShards",
    "NeighborSampler",
    "NodeBands",
    "PaddedCSR",
    "SampledBlock",
    "SampledSubgraph",
    "balance_report",
    "degree",
    "edge_partition",
    "erdos_renyi",
    "gcn_norm",
    "node_partition",
    "padded_csr_tensors",
    "powerlaw_graph",
    "relabel_to_local",
    "scatter_spmm",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
]
