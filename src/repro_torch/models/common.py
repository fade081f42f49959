"""Shared model building blocks: initialisers and the MLP.

The port's counterparts of ``repro.models.common`` for the GCN and Wide &
Deep: the same distributions (``dense_init`` N(0, 1)/√fan_in,
``embed_init`` N(0, 1)·0.02), drawn from an explicit ``torch.Generator``
on the parameter's device.  ``jax.random`` keys and torch generators give
different numbers from one seed: parity tests carry ``repro``'s
parameters across instead (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def dense_init(
    generator: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=generator, device=generator.device)
    return w.mul_(1.0 / (in_dim**0.5)).to(dtype)


def embed_init(
    generator: torch.Generator, vocab: int, dim: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    t = torch.randn((vocab, dim), generator=generator, device=generator.device)
    return t.mul_(0.02).to(dtype)


def mlp(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
) -> torch.Tensor:
    """``act`` between the layers, none after the last."""
    h = x
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < n - 1:
            h = act(h)
    return h


__all__ = ["dense_init", "embed_init", "mlp"]
