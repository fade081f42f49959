"""Optimizers over trees of tensors (the port of ``repro.optim.optimizers``).

The reference's functional interface:

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

A tree is nested dicts (walked in sorted key order, as JAX flattens
them), lists and tuples of tensors.  The moments live in f32 whatever
the parameter dtype (the reference's master-weights policy for bf16
training); each update is computed in f32 and cast back to the parameter
dtype, rounding once.

**The update is in place**: ``update`` writes the new values into the
parameter tensors and the moments (no second copy of either: at
``h2o-danube-1.8b``'s ``FULL`` size the f32 moments alone are 14.7 GB),
and returns the same parameter tree with a new :class:`OptState` whose
``step`` is a new tensor.  Call it only after the loss and every
gradient exist, so that a step that fails before the update leaves the
parameters as they were (the training loop retries such a step).
``torch.optim`` is not used: its AdamW keeps its state in the parameter
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Tree  # first moment (or momentum), f32
    nu: Optional[Tree]  # second moment (None for SGD), f32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], Tuple[Tree, OptState]]


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in JAX's flatten order (dict keys sorted; ``None`` is
    an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``tree``'s structure with ``fn`` applied to every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, tuple):
        out = [tree_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def tree_unflatten(tree: Tree, leaves: List[Any]) -> Tree:
    """``tree``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _zeros_like_f32(params: Tree) -> Tree:
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
    )


def _lr_fn(lr: Union[Schedule, float]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _init_step(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _matched(grads: Tree, *trees: Tree) -> List[List[torch.Tensor]]:
    flat = [tree_leaves(grads)] + [tree_leaves(t) for t in trees]
    n = len(flat[0])
    if any(len(f) != n for f in flat):
        raise ValueError(f"trees of {[len(f) for f in flat]} leaves do not match")
    return flat


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / ‖grads‖₂)`` (the norm in
    f32 over all leaves); returns the new tree and the norm."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _write_back(p: torch.Tensor, new32: torch.Tensor) -> None:
    """Store the f32 result into ``p`` (a no-op when it was computed in
    ``p`` itself), rounding once to ``p.dtype``."""
    if new32.data_ptr() != p.data_ptr():
        p.copy_(new32)


def adamw(
    lr: Union[Schedule, float],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Tree) -> OptState:
        return OptState(_init_step(params), _zeros_like_f32(params), _zeros_like_f32(params))

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree) -> Tuple[Tree, OptState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        s32 = step.float()
        b1c = 1.0 - torch.pow(b1, s32)
        b2c = 1.0 - torch.pow(b2, s32)
        for g, m, v, p in zip(*_matched(grads, state.mu, state.nu, params)):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1.0 - b1)  # b1·m + (1 − b1)·g
            v.mul_(b2).add_(torch.square(g32), alpha=1.0 - b2)  # b2·v + (1 − b2)·g²
            delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
            p32 = p.float()  # the parameter itself when it is f32
            delta.add_(p32, alpha=weight_decay).mul_(lr_t)
            _write_back(p, p32.sub_(delta))
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init=init, update=update)


def sgd_momentum(
    lr: Union[Schedule, float], *, momentum: float = 0.9, weight_decay: float = 0.0
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Tree) -> OptState:
        return OptState(_init_step(params), _zeros_like_f32(params), None)

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree) -> Tuple[Tree, OptState]:
        step = state.step + 1
        lr_t = lr_fn(step)
        for g, m, p in zip(*_matched(grads, state.mu, params)):
            p32 = p.float()
            g32 = g.float() + weight_decay * p32
            m.mul_(momentum).add_(g32)
            _write_back(p, p32 - lr_t * m)
        return params, OptState(step, state.mu, None)

    return Optimizer(init=init, update=update)


__all__ = [
    "OptState",
    "Optimizer",
    "adamw",
    "clip_by_global_norm",
    "sgd_momentum",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]
