"""Synthetic datasets: the drug–disease–target gold standard, the graphs
of the GNNs and the CTR batches of Wide & Deep."""

from repro_torch.data.drugnet import DrugNet, DrugNetSpec, make_drugnet
from repro_torch.data.lm import LMDataConfig, batch_iterator, sample_batch
from repro_torch.data.graphs import (
    NodeClassificationData,
    mesh_rollout_batch,
    molecule_batch,
    planted_partition_graph,
)
from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch

__all__ = [
    "CTRDataConfig",
    "DrugNet",
    "DrugNetSpec",
    "LMDataConfig",
    "NodeClassificationData",
    "batch_iterator",
    "make_drugnet",
    "mesh_rollout_batch",
    "molecule_batch",
    "planted_partition_graph",
    "sample_batch",
    "sample_ctr_batch",
]
