"""The port's models: GCN full-graph inference and Wide & Deep serving."""

from repro_torch.models.gnn import GCN, GCNConfig, gcn_adjacency, gcn_forward
from repro_torch.models.recsys import (
    WideDeep,
    WideDeepConfig,
    make_retrieval_scorer,
    make_serve,
)

__all__ = [
    "GCN",
    "GCNConfig",
    "WideDeep",
    "WideDeepConfig",
    "gcn_adjacency",
    "gcn_forward",
    "make_retrieval_scorer",
    "make_serve",
]
