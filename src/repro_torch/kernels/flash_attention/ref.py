"""Plain PyTorch version of the attention forward: the oracle.

Masked softmax attention with causal / sliding-window masks from
absolute positions, the port of ``repro``'s ``attention_ref``.  The CPU
tests hold it against ``repro``'s oracle and Pallas kernel; on the card
it is what the CUDA kernel is held to.  A row with no valid key gives NaN
(``-inf - -inf`` in the max-subtracted exponent), as ``repro``'s does.

:func:`gqa_attention_ref` is the one plain grouped-query attention of the
port: the CPU route of the kernel's wrapper, the model's plain route and
the yardstick the kernel is held to on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def attention_ref(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,  # (B, H, Lk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding window size (None = full)
    q_offset: int = 0,  # absolute position of q[0] (decode)
) -> torch.Tensor:
    """Scores and softmax in f32, returned in ``q.dtype``."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale.to(q.device)
    lq, lk = q.shape[2], k.shape[2]
    q_pos = torch.arange(lq, device=q.device) + q_offset
    k_pos = torch.arange(lk, device=q.device)
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-38)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def gqa_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    layout: str = "bhld",
    chunk: Optional[int] = None,
    remat: bool = False,
) -> torch.Tensor:
    """:func:`attention_ref` with grouped-query heads: KV head ``h // group``
    serves query head ``h``.

    ``layout="bhld"``: q ``(B, Hq, Lq, D)``, k and v ``(B, Hkv, Lk, D)``;
    ``"blhd"``: the sequence-major ``(B, L, H, D)``.  The output has q's
    layout and dtype.  ``chunk`` splits the queries into chunks of that
    many rows, each scored only against the keys its rows can see (both
    positions shifted, so the masks are unchanged): a long prompt's whole
    score matrix need not fit in memory.  The KV heads are repeated per
    chunk, over those keys only.  Without ``chunk`` it is
    :func:`attention_ref` on the repeated heads, bit for bit.  ``remat``
    (training) checkpoints each chunk: its f32 scores and softmax are
    recomputed in backward instead of kept, so one chunk's are live.
    """
    if layout == "blhd":
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        out = gqa_attention_ref(t(q), t(k), t(v), causal=causal, window=window,
                                q_offset=q_offset, chunk=chunk, remat=remat)
        return t(out)
    lq, lk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    step = max(1, chunk or lq)
    outs = []
    for a in range(0, max(lq, 1), step):
        e = min(lq, a + step)
        lo = max(0, q_offset + a - window + 1) if chunk and window else 0
        hi = min(lk, q_offset + e) if chunk and causal else lk
        if hi <= lo:  # no row of the chunk sees a key: keep them all, the mask gives NaN
            lo, hi = 0, lk
        outs.append(_chunk(q[:, :, a:e], k[:, :, lo:hi], v[:, :, lo:hi], group, causal,
                           window, q_offset + a - lo, remat))
    return torch.cat(outs, dim=2)


def _chunk_attention(q, k, v, group, causal, window, q_offset):
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _chunk(q, k, v, group, causal, window, q_offset, remat):
    if remat:
        return checkpoint(_chunk_attention, q, k, v, group, causal, window, q_offset,
                          use_reentrant=False)
    return _chunk_attention(q, k, v, group, causal, window, q_offset)


__all__ = ["attention_ref", "gqa_attention_ref"]
