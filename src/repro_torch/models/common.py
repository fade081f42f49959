"""Shared model building blocks: initialisers, the MLP, norms and RoPE.

The port's counterparts of ``repro.models.common`` for the GNNs, Wide &
Deep and the transformer: the same distributions (``dense_init`` N(0, 1)/√fan_in,
``embed_init`` N(0, 1)·0.02), drawn from an explicit ``torch.Generator``
on the parameter's device.  ``jax.random`` keys and torch generators give
different numbers from one seed: parity tests carry ``repro``'s
parameters across instead (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32, returned in ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Normalised over the last axis in f32 (f64 for f64 inputs; biased
    variance), scaled and shifted, returned in ``x.dtype``."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    centred = x32 - x32.mean(dim=-1, keepdim=True)
    var = centred.square().mean(dim=-1, keepdim=True)
    return (centred * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """``(silu(x W_g) ⊙ x W_u) W_d``; the SiLU in f32, the products in x's dtype."""
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ------------------------------------------------------------------- RoPE
def rope_frequencies(d_head: int, max_pos: int, theta: float = 10000.0, device=None):
    inv = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))
    pos = torch.arange(max_pos, dtype=torch.float32, device=device)
    ang = pos[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)  # (max_pos, d_head/2)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, D) with D even; positions: (..., L) absolute positions
    (broadcast against x's leading axes).

    Rotates the INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` in f32
    and restacks them, as ``repro`` does — not the half-split
    ``rotate_half`` form.
    """
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., None].float() * inv  # (..., L, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def causal_mask(
    lq: int, lk: int, q_offset: int = 0, window: Optional[int] = None, device=None
) -> torch.Tensor:
    q_pos = torch.arange(lq, device=device) + q_offset
    k_pos = torch.arange(lk, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits (..., V)`` against integer ``labels
    (...)``, in f32 (``repro.models.common.softmax_cross_entropy``)."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


__all__ = [
    "apply_rope",
    "causal_mask",
    "dense_init",
    "embed_init",
    "layer_norm",
    "mlp",
    "rms_norm",
    "rope_frequencies",
    "softmax_cross_entropy",
    "swiglu",
]
