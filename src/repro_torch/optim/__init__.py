"""Optimizers and learning-rate schedules (the port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd_momentum,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.step import make_train_step, trainable, value_and_grad
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "OptState",
    "Optimizer",
    "adamw",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
    "make_train_step",
    "sgd_momentum",
    "trainable",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
    "value_and_grad",
]
