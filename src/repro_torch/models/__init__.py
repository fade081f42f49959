"""The port's models: the GNN zoo (GCN, GAT, DimeNet, MeshGraphNet, SAGE)
inference, Wide & Deep serving and transformer serving (GQA or MLA attention,
dense or mixture-of-experts FFN)."""

from repro_torch.models.gnn import (
    GAT,
    GCN,
    SAGE,
    DimeNet,
    DimeNetConfig,
    GATConfig,
    GCNConfig,
    MeshGraphNet,
    MGNConfig,
    SageConfig,
    build_triplets,
    gcn_adjacency,
    gcn_adjacency_live,
    gcn_forward,
)
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
    "DimeNet",
    "DimeNetConfig",
    "GAT",
    "GATConfig",
    "GCN",
    "GCNConfig",
    "MGNConfig",
    "MeshGraphNet",
    "SAGE",
    "SageConfig",
    "Transformer",
    "TransformerConfig",
    "WideDeep",
    "WideDeepConfig",
    "build_triplets",
    "gcn_adjacency",
    "gcn_adjacency_live",
    "gcn_forward",
    "init_cache",
    "make_decode_step",
    "make_prefill",
    "make_retrieval_scorer",
    "make_serve",
]
