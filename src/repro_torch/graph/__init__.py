"""Graph substrate of the GNN models: containers and segment reductions."""

from repro_torch.graph.segment import (
    degree,
    gcn_norm,
    scatter_spmm,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from repro_torch.graph.structures import EdgeList, PaddedCSR, padded_csr_tensors

__all__ = [
    "EdgeList",
    "PaddedCSR",
    "degree",
    "gcn_norm",
    "padded_csr_tensors",
    "scatter_spmm",
    "segment_max",
    "segment_mean",
    "segment_softmax",
    "segment_sum",
]
