from repro_torch.kernels.embedding_bag.ops import LAUNCHES, embedding_bag_op
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["LAUNCHES", "embedding_bag_op", "embedding_bag_ref"]
