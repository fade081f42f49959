"""Synthetic datasets: the drug–disease–target gold standard, the
planted-partition graphs of the GCN and the CTR batches of Wide & Deep."""

from repro_torch.data.drugnet import DrugNet, DrugNetSpec, make_drugnet
from repro_torch.data.graphs import NodeClassificationData, planted_partition_graph
from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch

__all__ = [
    "CTRDataConfig",
    "DrugNet",
    "DrugNetSpec",
    "NodeClassificationData",
    "make_drugnet",
    "planted_partition_graph",
    "sample_ctr_batch",
]
