"""GCN full-graph inference (Kipf & Welling, arXiv:1609.02907).

The port's counterpart of ``gcn_init`` / ``gcn_forward`` in
``repro.models.gnn``.  Each layer aggregates over the symmetric-normalised
adjacency with self-loops, then applies ``h @ W + b``, with ReLU between
the layers.  The reference aggregates with a COO ``scatter_spmm``; here
the aggregate runs on the padded CSR that ``repro.graph.structures``
describes as the kernels' layout, through the ``csr_aggregate`` kernel
(one launch per layer) — the path ``repro``'s documents name for it —
which stops each row after its live slots (:func:`gcn_adjacency_live`).

Inference only: the parameters do not require gradients.  The training
step (loss, optimiser and the backward through the kernel) comes later.
GAT, DimeNet, MeshGraphNet and SAGE wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.segment import gcn_norm, scatter_spmm
from repro_torch.graph.structures import EdgeList, padded_csr_tensors
from repro_torch.kernels.segment_reduce import LiveRows, csr_aggregate_op, csr_aggregate_ref
from repro_torch.models.common import dense_init


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    dtype: torch.dtype = torch.float32

    @property
    def dims(self) -> List[int]:
        return [self.d_feat] + [self.d_hidden] * (self.n_layers - 1) + [self.n_classes]


def gcn_adjacency_live(
    edges: EdgeList, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor, LiveRows]:
    """The GCN operator ``D^{-1/2} A D^{-1/2}`` as a padded CSR on ``device``,
    with each row's live length.

    ``edges`` is the graph with its self-loops (``symmetrized()
    .with_self_loops()``, as ``planted_partition_graph`` gives it).
    Prepared once per graph; returns ``(nbr, wgt, live)``: ``(N, max_deg)``
    int32 and f32, and the in-degrees as :class:`LiveRows`.  Every edge
    weight of the normalised operator is positive and the pads are
    ``(0, 0.0)``, so a row's degree is one past its last nonzero slot.
    """
    dev = resolve_device(device)
    src, dst, w = (
        torch.from_numpy(a).to(dev) for a in (edges.src, edges.dst, edges.weights())
    )
    wn = gcn_norm(src, dst, w, edges.num_nodes)
    del w
    nbr, wgt, deg = padded_csr_tensors(src, dst, wn, edges.num_nodes)
    lengths = deg.clamp(max=nbr.shape[1]).int()
    return nbr, wgt, LiveRows(lengths, int(lengths.sum()))


def gcn_adjacency(edges: EdgeList, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gcn_adjacency_live` without the live lengths: ``(nbr, wgt)``."""
    nbr, wgt, _ = gcn_adjacency_live(edges, device)
    return nbr, wgt


class GCN(nn.Module):
    """``cfg.n_layers`` graph convolutions over a prepared padded CSR.

    ``use_kernel=False`` aggregates with the plain PyTorch version on the
    card too (the yardstick path); on CPU tensors both are the plain one.
    """

    def __init__(
        self,
        cfg: GCNConfig,
        *,
        generator: torch.Generator = None,
        device: DeviceLike = None,
        use_kernel: bool = True,
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        dims = cfg.dims
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.weights = nn.ParameterList(
            nn.Parameter(dense_init(gen, a, b, cfg.dtype), requires_grad=False)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(b, dtype=cfg.dtype, device=dev), requires_grad=False)
            for b in dims[1:]
        )

    def forward(
        self,
        feats: torch.Tensor,
        nbr: torch.Tensor,
        wgt: torch.Tensor,
        live: Optional[LiveRows] = None,
    ) -> torch.Tensor:
        """Logits ``(N, n_classes)`` for node features ``(N, d_feat)``.

        ``live`` (from :func:`gcn_adjacency_live`) lets the kernel skip each
        row's pads; the plain path sums every slot, the same function."""
        h = feats
        last = len(self.weights) - 1
        for i, (W, b) in enumerate(zip(self.weights, self.biases)):
            if self.use_kernel:
                h = csr_aggregate_op(nbr, wgt, h, live=live)  # Ã h
            else:
                h = csr_aggregate_ref(nbr, wgt, h)
            h = h @ W + b
            if i < last:
                h = torch.relu(h)
        return h


def gcn_forward(
    cfg: GCNConfig,
    params: Dict[str, list],
    feats: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """The reference's functional forward over a COO operator (plain ops);
    ``params`` is ``{"w": [...], "b": [...]}``."""
    h = feats
    for i, (W, b) in enumerate(zip(params["w"], params["b"])):
        h = scatter_spmm(src, dst, w, h, num_nodes)  # Ã h
        h = h @ W + b
        if i < len(params["w"]) - 1:
            h = torch.relu(h)
    return h


__all__ = ["GCN", "GCNConfig", "gcn_adjacency", "gcn_adjacency_live", "gcn_forward"]
