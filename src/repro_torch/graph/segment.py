"""Segment-reduce message-passing primitives on tensors.

The port's counterparts of ``repro.graph.segment``: reductions over an
edge-index scatter (``index_add_``, ``scatter_reduce_``).  Like JAX's
``segment_*`` they return the identity of the reduction for an empty
segment; unlike JAX they raise on an id outside ``[0, num_segments)``.
``scatter_spmm`` keeps the reference's COO signature: it is the plain
edge-list path the tests compare with.  The GCN forward on the card
aggregates over the padded CSR instead, through the ``csr_aggregate``
kernel (:mod:`repro_torch.models.gnn`).
"""

from __future__ import annotations

import torch


def _zeros(data: torch.Tensor, num_segments: int) -> torch.Tensor:
    return torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                       device=data.device)


def _expand(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    return ids.expand(data.shape)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _zeros(data, num_segments).index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(
        torch.ones(data.shape[:1], dtype=data.dtype, device=data.device),
        segment_ids,
        num_segments,
    )
    return total / count.clamp(min=1.0).reshape((-1,) + (1,) * (data.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max; ``-inf`` for an empty segment (JAX's identity)."""
    init = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                      dtype=data.dtype, device=data.device)
    return init.scatter_reduce(0, _expand(segment_ids, data), data, reduce="amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment min; ``+inf`` (an integer type's largest value) for an
    empty segment (JAX's identity)."""
    top = float("inf") if data.dtype.is_floating_point else torch.iinfo(data.dtype).max
    init = torch.full((num_segments,) + tuple(data.shape[1:]), top, dtype=data.dtype,
                      device=data.device)
    return init.scatter_reduce_(0, _expand(segment_ids, data), data, reduce="amin")


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment (GAT edge softmax)."""
    ids = segment_ids.long()
    shifted = scores - segment_max(scores, ids, num_segments)[ids]
    expd = torch.exp(shifted)
    denom = segment_sum(expd, ids, num_segments)
    return expd / denom[ids].clamp(min=1e-38)


def scatter_spmm(
    src: torch.Tensor,  # (E,) int — message source node per edge
    dst: torch.Tensor,  # (E,) int — message destination node per edge
    w: torch.Tensor,  # (E,) float — edge weight
    F: torch.Tensor,  # (N, D) node features / labels
    num_nodes: int,
    *,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(W @ F)`` for a COO operator W: ``out[v] = Σ_{e: dst=v} w_e · F[src_e]``."""
    msgs = w[:, None].to(accum_dtype) * F[src.long()].to(accum_dtype)
    return segment_sum(msgs, dst, num_nodes).to(F.dtype)


def degree(dst: torch.Tensor, num_nodes: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return segment_sum(torch.ones(dst.shape, dtype=dtype, device=dst.device), dst, num_nodes)


def gcn_norm(
    src: torch.Tensor,  # (E,) int
    dst: torch.Tensor,  # (E,) int
    w: torch.Tensor,  # (E,) float
    num_nodes: int,
) -> torch.Tensor:
    """Edge weights of ``D^{-1/2} A D^{-1/2}`` for ``A[dst, src] = w``, f32.

    The edge-list form of ``EdgeList.from_dense(symmetric_normalize(
    edges.to_dense()))`` (what ``repro.launch.train.build_gnn_job``
    builds): ``D`` is A's row sum, a zero degree gets a zero inverse, and
    the product is taken in f64 in the reference's order and rounded once
    to f32.  The one difference: two copies of an edge (a self-loop added
    to a graph that had one) stay two entries instead of one of twice the
    weight — the same operator.
    """
    dst = dst.long()
    src = src.long()
    w64 = w.double()
    deg = torch.zeros(num_nodes, dtype=torch.float64, device=w.device).index_add_(0, dst, w64)
    inv = torch.zeros_like(deg)
    nz = deg > 0
    inv[nz] = 1.0 / torch.sqrt(deg[nz])
    return (inv[dst] * w64 * inv[src]).float()


__all__ = [
    "degree",
    "gcn_norm",
    "scatter_spmm",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
]
