"""One training step over a tree of parameters: the loss, every gradient,
then the optimizer's update (``jax.value_and_grad`` + ``opt.update`` in
the reference's train steps)."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer, OptState, tree_leaves, tree_unflatten

Tree = Any


def trainable(params: Tree) -> Tree:
    """Make every leaf of ``params`` require a gradient (the models are
    built frozen for serving); returns ``params``."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def value_and_grad(loss_fn: Callable[..., torch.Tensor], params: Tree, *args
                   ) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn(params, *args)`` and its gradient with respect to every
    leaf of ``params``, as a tree of the same structure.  A leaf the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it."""
    with torch.enable_grad():
        leaves = tree_leaves(trainable(params))
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable[[Tree, Any], torch.Tensor], optimizer: Optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    loss and every gradient first, then the optimizer's in-place update,
    so that a step that fails before the update changes nothing."""

    def step(params: Tree, opt_state: OptState, batch) -> Tuple[Tree, OptState, torch.Tensor]:
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


__all__ = ["make_train_step", "trainable", "value_and_grad"]
