"""Synthetic datasets: the drug–disease–target gold standard."""

from repro_torch.data.drugnet import DrugNet, DrugNetSpec, make_drugnet

__all__ = ["DrugNet", "DrugNetSpec", "make_drugnet"]
