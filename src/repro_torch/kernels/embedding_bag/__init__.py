from repro_torch.kernels.embedding_bag.ops import (
    LAUNCHES,
    BagPlan,
    bag_plan,
    embedding_bag_op,
    launch_plan,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["LAUNCHES", "BagPlan", "bag_plan", "embedding_bag_op", "embedding_bag_ref",
           "launch_plan"]
