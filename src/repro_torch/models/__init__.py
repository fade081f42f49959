"""The port's models: GCN full-graph inference, Wide & Deep serving and
transformer serving (GQA, dense FFN)."""

from repro_torch.models.gnn import GCN, GCNConfig, gcn_adjacency, gcn_adjacency_live, gcn_forward
from repro_torch.models.recsys import (
    WideDeep,
    WideDeepConfig,
    make_retrieval_scorer,
    make_serve,
)
from repro_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    init_cache,
    make_decode_step,
    make_prefill,
)

__all__ = [
    "GCN",
    "GCNConfig",
    "Transformer",
    "TransformerConfig",
    "WideDeep",
    "WideDeepConfig",
    "gcn_adjacency",
    "gcn_adjacency_live",
    "gcn_forward",
    "init_cache",
    "make_decode_step",
    "make_prefill",
    "make_retrieval_scorer",
    "make_serve",
]
