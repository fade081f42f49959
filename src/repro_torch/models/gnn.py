"""The GNN zoo: GCN, GAT, DimeNet, MeshGraphNet and sampled-minibatch SAGE.

The port's counterparts of ``repro.models.gnn``, as ``nn.Module``s whose
``forward`` is the reference's forward function of the same model, with
parameters of the reference's shapes and distributions.  Each model's
forward is also a function of its parameter tree (``gcn_forward_csr``,
``gat_forward``, ``dimenet_forward``, ``mgn_forward``, ``sage_forward``),
the tree being ``model.param_tree()``: the module's own parameters laid
out as the reference's pytree, which the train steps
(:mod:`repro_torch.configs.cells`) differentiate.  The modules are built
frozen (serving); a train step makes the tree's leaves require grad.

* **GCN** (Kipf & Welling, arXiv:1609.02907): each layer aggregates over
  the symmetric-normalised adjacency with self-loops, then applies
  ``h @ W + b``, with ReLU between the layers.  The reference aggregates
  with a COO ``scatter_spmm``; here the aggregate runs on the padded CSR
  that ``repro.graph.structures`` describes as the kernels' layout,
  through the ``csr_aggregate`` kernel B4 (one launch per layer), which
  stops each row after its live slots (:func:`gcn_adjacency_live`).  In
  training the aggregate's gradient is B4 again, on the transposed
  operator (:class:`~repro_torch.kernels.segment_reduce.CSRAggregate`):
  :func:`csr_operator` / :func:`gcn_operator` build the operator and its
  transpose once per graph.  Only layer 2's input needs a gradient: one
  backward launch a step.
* **SAGE**, the sampled ``minibatch_lg`` mode of GCN and GAT: each hop's
  mean over a padded ``(B, fanout)`` neighbour block is B4 with weights
  ``mask / count`` (one launch per hop; in training one more per hop
  backward, on the transposes :func:`sage_hops` builds).
* **GAT**, **DimeNet** and **MeshGraphNet** aggregate with the port's
  segment ops (``index_add_``), as the reference computes them with
  ``segment_sum`` outside any Pallas kernel.  GAT adds its messages in
  edge chunks: at ``ogb_products`` one unchunked ``(E, 64)`` f32 message
  tensor is 15.8 GB; in training each chunk is checkpointed (recomputed
  in backward), so no chunk's gathered rows outlive it.

``use_kernel=False`` takes B4's plain version on the card too (the
yardstick path); on CPU tensors both routes are the plain one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as tnf
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.segment import gcn_norm, scatter_spmm, segment_softmax, segment_sum
from repro_torch.graph.structures import EdgeList, padded_csr_tensors
from repro_torch.kernels.segment_reduce import (
    CSRAggregate,
    CSRTranspose,
    LiveRows,
    csr_aggregate_op,
    csr_aggregate_ref,
    transpose_padded_csr,
)
from repro_torch.models.common import dense_init, layer_norm, mlp


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


def _aggregate(nbr, wgt, F, live=None, transpose=None) -> torch.Tensor:
    """B4 on the models' path: :class:`~repro_torch.kernels.segment_reduce.
    CSRAggregate` when autograd records ``F`` (its backward is B4 on
    ``transpose``, which is then required), else ``csr_aggregate_op``."""
    if torch.is_grad_enabled() and F.requires_grad:
        if transpose is None:
            raise ValueError("csr_aggregate: F requires grad but no transposed operator was "
                             "given (transpose_padded_csr, built once per graph)")
        return CSRAggregate.apply(F, nbr, wgt, live, transpose)
    return csr_aggregate_op(nbr, wgt, F, live=live)


class CSROperator(NamedTuple):
    """A padded-CSR aggregate operator with what training needs beside it:
    ``(nbr, wgt)`` (M, D), the rows' live lengths and the transpose
    (:func:`~repro_torch.kernels.segment_reduce.transpose_padded_csr`)."""

    nbr: torch.Tensor
    wgt: torch.Tensor
    live: LiveRows
    transpose: CSRTranspose


def csr_operator(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                 num_nodes: int) -> CSROperator:
    """The COO operator ``A[dst, src] += w`` as a :class:`CSROperator` on
    the edges' device: the padded CSR in stable destination order, its
    live lengths (the in-degrees) and its transpose, built once per graph."""
    nbr, wgt, deg = padded_csr_tensors(src, dst, w, num_nodes)
    wgt = wgt.to(w.dtype)
    live = LiveRows(deg.int(), int(deg.sum()))
    return CSROperator(nbr, wgt, live, transpose_padded_csr(nbr, wgt, num_nodes))


def gcn_operator(edges: EdgeList, device: DeviceLike = None) -> CSROperator:
    """:func:`gcn_adjacency_live` with the operator's transpose beside it
    (the train path's operator)."""
    nbr, wgt, live = gcn_adjacency_live(edges, device)
    return CSROperator(nbr, wgt, live, transpose_padded_csr(nbr, wgt, edges.num_nodes))


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

    def param_tree(self) -> Dict[str, list]:
        """The parameters as the reference's ``{"w": [...], "b": [...]}``."""
        return {"w": list(self.weights), "b": list(self.biases)}

    def forward(
        self,
        feats: torch.Tensor,
        nbr: torch.Tensor,
        wgt: torch.Tensor,
        live: Optional[LiveRows] = None,
        transpose: Optional[CSRTranspose] = None,
    ) -> torch.Tensor:
        """Logits ``(N, n_classes)`` for node features ``(N, d_feat)``.

        ``live`` (from :func:`gcn_adjacency_live`) lets the kernel skip each
        row's pads; the plain path sums every slot, the same function.
        ``transpose`` is needed when the parameters require grad."""
        return gcn_forward_csr(self.param_tree(), feats, nbr, wgt, live, transpose,
                               use_kernel=self.use_kernel)


def gcn_forward_csr(
    params: Dict[str, list],
    feats: torch.Tensor,
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    live: Optional[LiveRows] = None,
    transpose: Optional[CSRTranspose] = None,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """GCN over a padded CSR with the parameter tree ``{"w", "b"}``: each
    layer's aggregate on B4 (``use_kernel``; with a gradient through
    ``CSRAggregate``, which needs ``transpose``) or on its plain version
    (differentiable as it is)."""
    h = feats
    last = len(params["w"]) - 1
    for i, (W, b) in enumerate(zip(params["w"], params["b"])):
        if use_kernel:
            h = _aggregate(nbr, wgt, h, live, transpose)  # Ã h
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


def _fixed(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _generator(generator: Optional[torch.Generator], device: DeviceLike) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=resolve_device(device)).manual_seed(0)


# ===================================================================== GAT
@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    dtype: torch.dtype = torch.float32

    def layer_dims(self) -> List[Tuple[int, int, int]]:
        """``(d_in, heads, d_out)`` per layer: ``n_heads`` concatenated heads
        of ``d_hidden`` between layers, one head of ``n_classes`` last."""
        dims, d_in = [], self.d_feat
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            heads, d_out = (1, self.n_classes) if last else (self.n_heads, self.d_hidden)
            dims.append((d_in, heads, d_out))
            d_in = heads * d_out
        return dims


#: edges whose messages one ``index_add_`` of GAT's aggregate adds
GAT_EDGE_CHUNK = 1 << 22


class GAT(nn.Module):
    """Graph attention (arXiv:1710.10903) over a COO edge list, per layer:
    SDDMM edge scores, a per-destination softmax, then the weighted sum of
    the source rows (``GAT_EDGE_CHUNK`` edges at a time)."""

    def __init__(self, cfg: GATConfig, *, generator: torch.Generator = None,
                 device: DeviceLike = None):
        super().__init__()
        gen = _generator(generator, device)
        self.cfg = cfg
        self.layers = nn.ModuleList()
        for d_in, heads, d_out in cfg.layer_dims():
            # the reference draws a_src and a_dst from one key: they are equal
            a = 0.1 * dense_init(gen, heads, d_out, cfg.dtype)
            self.layers.append(nn.ParameterDict({
                "w": _fixed(dense_init(gen, d_in, heads * d_out, cfg.dtype)),
                "a_src": _fixed(a),
                "a_dst": _fixed(a.clone()),
            }))

    def param_tree(self) -> Dict[str, list]:
        """The reference's ``{"layers": [{"w", "a_src", "a_dst"}, ...]}``."""
        return {"layers": [dict(lp.items()) for lp in self.layers]}

    def forward(
        self, feats: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
        num_nodes: Optional[int] = None,
    ) -> torch.Tensor:
        """Logits ``(N, n_classes)``; ``src``/``dst`` (E,) int, messages
        flow ``src -> dst``."""
        return gat_forward(self.param_tree(), feats, src, dst, num_nodes)


def _gat_messages(alpha, hw, src, dst, n):
    """One edge chunk's messages added into an ``(n, H·D)`` zero buffer."""
    msgs = alpha[:, :, None] * hw[src]  # (chunk, H, D)
    return hw.new_zeros((n, hw.shape[1] * hw.shape[2])).index_add_(
        0, dst, msgs.reshape(msgs.shape[0], -1))


def gat_forward(params: Dict[str, list], feats: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, num_nodes: Optional[int] = None) -> torch.Tensor:
    """GAT over the parameter tree ``{"layers": [...]}``.  With autograd
    recording, each edge chunk's messages are a checkpointed function
    (recomputed in backward), so no chunk's ``(chunk, H, D)`` rows stay."""
    n = feats.shape[0] if num_nodes is None else int(num_nodes)
    src, dst = src.long(), dst.long()
    h = feats
    last = len(params["layers"]) - 1
    for i, lp in enumerate(params["layers"]):
        heads, d_out = lp["a_src"].shape
        hw = (h @ lp["w"]).reshape(-1, heads, d_out)
        e_src = torch.einsum("nhd,hd->nh", hw, lp["a_src"])
        e_dst = torch.einsum("nhd,hd->nh", hw, lp["a_dst"])
        alpha = segment_softmax(
            tnf.leaky_relu(e_src[src] + e_dst[dst], negative_slope=0.2), dst, n
        )  # (E, H)
        agg = hw.new_zeros((n, heads * d_out))
        remat = torch.is_grad_enabled() and (alpha.requires_grad or hw.requires_grad)
        for e0 in range(0, src.shape[0], GAT_EDGE_CHUNK):
            sl = slice(e0, e0 + GAT_EDGE_CHUNK)
            if remat:
                agg = agg + checkpoint(_gat_messages, alpha[sl], hw, src[sl], dst[sl], n,
                                       use_reentrant=False)
            else:
                msgs = alpha[sl, :, None] * hw[src[sl]]  # (chunk, H, D)
                agg.index_add_(0, dst[sl], msgs.reshape(-1, heads * d_out))
        del alpha
        h = agg if i == last else tnf.elu(agg)
    return h


# ================================================================= DimeNet
@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    n_species: int = 16
    cutoff: float = 5.0
    out_dim: int = 1
    dtype: torch.dtype = torch.float32


def _rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """DimeNet radial basis: sin(nπ d/c)/d with a smooth cutoff envelope."""
    d = d.clamp(min=1e-6)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)[None, :]
    u = d / cutoff
    env = 1.0 - 6.0 * u**5 + 15.0 * u**4 - 10.0 * u**3  # C² envelope
    return env * math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * u) / d


def _sbf(d: torch.Tensor, angle: torch.Tensor, n_spherical: int, n_radial: int,
         cutoff: float) -> torch.Tensor:
    """Angular × radial basis: cos(l·θ) angular modes times the radial sine
    family (the reference's stand-in for spherical Bessel × Legendre)."""
    u = (d.clamp(min=1e-6) / cutoff)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)[None, :]
    radial = torch.sin(n * math.pi * u) / (u * cutoff)  # (T, R)
    ls = torch.arange(n_spherical, dtype=torch.float32, device=d.device)[None, :]
    angular = torch.cos(ls * angle[:, None])  # (T, S)
    out = angular[:, :, None] * radial[:, None, :]  # (T, S, R)
    return out.reshape(d.shape[0], n_spherical * n_radial)


class DimeNet(nn.Module):
    """Directional message passing (arXiv:2003.03123): edge messages
    updated from triplets ``(k→j, j→i)`` through an angular-radial basis
    and a bilinear layer, then summed into nodes and per graph."""

    def __init__(self, cfg: DimeNetConfig, *, generator: torch.Generator = None,
                 device: DeviceLike = None):
        super().__init__()
        gen = _generator(generator, device)
        self.cfg = cfg
        h, nb, dt = cfg.d_hidden, cfg.n_bilinear, cfg.dtype
        sph = cfg.n_spherical * cfg.n_radial
        self.embed_z = _fixed(0.1 * dense_init(gen, cfg.n_species, h, dt))
        self.rbf_proj = _fixed(dense_init(gen, cfg.n_radial, h, dt))
        self.msg_mlp_w = _fixed(dense_init(gen, 3 * h, h, dt))
        self.msg_mlp_b = _fixed(torch.zeros(h, dtype=dt, device=gen.device))
        self.out_w1 = _fixed(dense_init(gen, h, h, dt))
        self.out_w2 = _fixed(dense_init(gen, h, cfg.out_dim, dt))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({
                "w_src": _fixed(dense_init(gen, h, h, dt)),
                "w_kj": _fixed(dense_init(gen, h, nb, dt)),
                "sbf_proj": _fixed(dense_init(gen, sph, nb, dt)),
                "bilinear": _fixed(
                    0.1 * torch.randn((nb, nb, h), generator=gen, device=gen.device).to(dt)
                ),
                "w_out": _fixed(dense_init(gen, h, h, dt)),  # in the reference's params, unused
                "w_res": _fixed(dense_init(gen, h, h, dt)),
            })
            for _ in range(cfg.n_blocks)
        )

    def param_tree(self) -> Dict:
        """The reference's pytree: the named weights and ``"blocks"``."""
        names = ("embed_z", "rbf_proj", "msg_mlp_w", "msg_mlp_b", "out_w1", "out_w2")
        tree = {name: getattr(self, name) for name in names}
        tree["blocks"] = [dict(blk.items()) for blk in self.blocks]
        return tree

    def forward(self, *args) -> torch.Tensor:
        """Energies ``(num_graphs, out_dim)``: :func:`dimenet_forward`'s
        arguments after the parameters."""
        return dimenet_forward(self.cfg, self.param_tree(), *args)


def dimenet_forward(
    cfg: DimeNetConfig,
    params: Dict,
    z: torch.Tensor,  # (N,) species ids
    pos: torch.Tensor,  # (N, 3)
    edge_src: torch.Tensor,  # (E,) j (message j→i)
    edge_dst: torch.Tensor,  # (E,) i
    tri_kj: torch.Tensor,  # (T,) edge index of k→j
    tri_ji: torch.Tensor,  # (T,) edge index of j→i
    tri_mask: torch.Tensor,  # (T,) bool or 0/1 (padding)
    graph_ids: torch.Tensor,  # (N,) graph of each node
    num_graphs: int,
) -> torch.Tensor:
    """DimeNet over its parameter tree: energies ``(num_graphs, out_dim)``."""
    src, dst = edge_src.long(), edge_dst.long()
    kj, ji = tri_kj.long(), tri_ji.long()
    num_nodes, e = z.shape[0], src.shape[0]
    vec = pos[dst] - pos[src]  # (E, 3)
    dist = torch.sqrt((vec**2).sum(dim=-1) + 1e-12)
    rbf = _rbf(dist, cfg.n_radial, cfg.cutoff)  # (E, R)
    # the angle between edges k→j and j→i at their shared node j
    v1 = -vec[kj]
    v2 = vec[ji]
    cosang = (v1 * v2).sum(dim=-1) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)
    ).clamp(min=1e-9)
    angle = torch.arccos(cosang.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    sbf = _sbf(dist[ji], angle, cfg.n_spherical, cfg.n_radial, cfg.cutoff)  # (T, S·R)

    hz = params["embed_z"][z.long()]  # (N, H)
    m = tnf.silu(
        torch.cat([hz[src], hz[dst], rbf @ params["rbf_proj"]], dim=-1) @ params["msg_mlp_w"]
        + params["msg_mlp_b"]
    )  # (E, H)
    mask = tri_mask.to(m.dtype)[:, None]
    nb = cfg.n_bilinear
    for blk in params["blocks"]:
        # m_ji ← f(m_ji, Σ_k sbf ⊙ bilinear(m_kj))
        m_kj = (m @ blk["w_kj"])[kj]  # (T, nb)
        sb = sbf @ blk["sbf_proj"]  # (T, nb)
        outer = (m_kj[:, :, None] * sb[:, None, :]).reshape(-1, nb * nb)
        inter = (outer @ blk["bilinear"].reshape(nb * nb, -1)) * mask  # (T, H)
        agg = segment_sum(inter, ji, e)  # (E, H)
        upd = tnf.silu(m @ blk["w_src"] + agg)
        m = m + tnf.silu(upd @ blk["w_res"])
    # per-node readout: sum the incoming messages, then per graph
    node_out = tnf.silu(segment_sum(m, dst, num_nodes) @ params["out_w1"])
    return segment_sum(node_out @ params["out_w2"], graph_ids, num_graphs)


def build_triplets(src, dst, num_nodes: int, max_triplets: Optional[int] = None):
    """Host triplet index of DimeNet: for each edge ``j→i`` (in edge order)
    and each in-edge ``k→j`` of j (in edge order) with ``k != i``, the pair
    (edge k→j, edge j→i).  Returns padded int32 ``(kj, ji)`` and a bool
    mask, ``max_triplets`` long (all triplets when None).  The reference's
    double loop, vectorised: the same triplets in the same order."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    e = len(src)
    in_edges = np.argsort(dst, kind="stable")  # grouped by node, edge order within
    indeg = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    starts = np.cumsum(indeg) - indeg
    count = indeg[src]  # in-edges of j = src[eid], for each edge eid
    ji = np.repeat(np.arange(e, dtype=np.int64), count)
    first = np.cumsum(count) - count
    rank = np.arange(int(count.sum()), dtype=np.int64) - np.repeat(first, count)
    kj = in_edges[np.repeat(starts[src], count) + rank]
    keep = src[kj] != dst[ji]  # no backtracking k == i
    kj, ji = kj[keep], ji[keep]
    t = len(kj)
    cap = t if max_triplets is None else max_triplets
    n = min(t, cap)
    kj_a = np.zeros(cap, np.int32)
    ji_a = np.zeros(cap, np.int32)
    mask = np.zeros(cap, bool)
    kj_a[:n] = kj[:n]
    ji_a[:n] = ji[:n]
    mask[:n] = True
    return kj_a, ji_a, mask


# ============================================================ MeshGraphNet
@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3
    dtype: torch.dtype = torch.float32


class _MGNMLP(nn.Module):
    """ReLU MLP of ``n_layers`` layers, then a LayerNorm (``norm=True``)."""

    def __init__(self, gen, d_in, d_hidden, d_out, n_layers, dtype):
        super().__init__()
        dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
        self.w = nn.ParameterList(
            _fixed(dense_init(gen, a, b, dtype)) for a, b in zip(dims[:-1], dims[1:])
        )
        self.b = nn.ParameterList(
            _fixed(torch.zeros(b, dtype=dtype, device=gen.device)) for b in dims[1:]
        )
        self.ln_g = _fixed(torch.ones(d_out, dtype=dtype, device=gen.device))
        self.ln_b = _fixed(torch.zeros(d_out, dtype=dtype, device=gen.device))

    def param_tree(self) -> Dict:
        return {"w": list(self.w), "b": list(self.b), "ln_g": self.ln_g, "ln_b": self.ln_b}

    def forward(self, x: torch.Tensor, norm: bool = True) -> torch.Tensor:
        return _mgn_mlp(self.param_tree(), x, norm)


def _mgn_mlp(p: Dict, x: torch.Tensor, norm: bool = True) -> torch.Tensor:
    h = mlp(x, p["w"], p["b"])
    return layer_norm(h, p["ln_g"], p["ln_b"]) if norm else h


class MeshGraphNet(nn.Module):
    """Encode-process-decode (arXiv:2010.03409): per layer an edge MLP on
    ``[e, h[src], h[dst]]``, a sum over each node's in-edges and a node
    MLP, both residual."""

    def __init__(self, cfg: MGNConfig, *, generator: torch.Generator = None,
                 device: DeviceLike = None):
        super().__init__()
        gen = _generator(generator, device)
        self.cfg = cfg
        h, k, dt = cfg.d_hidden, cfg.mlp_layers, cfg.dtype
        self.node_enc = _MGNMLP(gen, cfg.d_node_in, h, h, k, dt)
        self.edge_enc = _MGNMLP(gen, cfg.d_edge_in, h, h, k, dt)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "edge": _MGNMLP(gen, 3 * h, h, h, k, dt),
                "node": _MGNMLP(gen, 2 * h, h, h, k, dt),
            })
            for _ in range(cfg.n_layers)
        )
        self.decoder = _MGNMLP(gen, h, h, cfg.d_out, k, dt)

    def param_tree(self) -> Dict:
        """The reference's pytree: the encoders, ``"blocks"`` and the decoder,
        each MLP ``{"w", "b", "ln_g", "ln_b"}``."""
        return {
            "node_enc": self.node_enc.param_tree(),
            "edge_enc": self.edge_enc.param_tree(),
            "blocks": [{"edge": blk["edge"].param_tree(), "node": blk["node"].param_tree()}
                       for blk in self.blocks],
            "decoder": self.decoder.param_tree(),
        }

    def forward(
        self, node_feat: torch.Tensor, edge_feat: torch.Tensor, src: torch.Tensor,
        dst: torch.Tensor, num_nodes: Optional[int] = None,
    ) -> torch.Tensor:
        """Per-node outputs ``(N, d_out)``."""
        return mgn_forward(self.param_tree(), node_feat, edge_feat, src, dst, num_nodes)


def mgn_forward(params: Dict, node_feat: torch.Tensor, edge_feat: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
    """MeshGraphNet over its parameter tree: per-node outputs ``(N, d_out)``."""
    n = node_feat.shape[0] if num_nodes is None else int(num_nodes)
    src, dst = src.long(), dst.long()
    h = _mgn_mlp(params["node_enc"], node_feat)
    e = _mgn_mlp(params["edge_enc"], edge_feat)
    for blk in params["blocks"]:
        e = e + _mgn_mlp(blk["edge"], torch.cat([e, h[src], h[dst]], dim=-1))  # edge update
        agg = segment_sum(e, dst, n)  # the sum aggregator
        h = h + _mgn_mlp(blk["node"], torch.cat([h, agg], dim=-1))
    return _mgn_mlp(params["decoder"], h, norm=False)


# ================================================ sampled-minibatch (SAGE)
@dataclasses.dataclass(frozen=True)
class SageConfig:
    name: str
    d_feat: int
    d_hidden: int
    n_classes: int
    fanouts: Tuple[int, ...] = (15, 10)
    dtype: torch.dtype = torch.float32


Hop = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class SAGE(nn.Module):
    """GraphSAGE-style hop aggregation over sampled fanout blocks: the
    ``minibatch_lg`` execution of the message-passing archs (the mean
    aggregator, GCN's sym-norm becoming the sampled-mean estimator).

    Each hop's mean is ``Σ_k (mask / max(count, 1))[b, k] · h[nbr[b, k]]``:
    B4 (``csr_aggregate_op``, one launch per hop) with ``use_kernel``, its
    plain version without.
    """

    def __init__(self, cfg: SageConfig, *, generator: torch.Generator = None,
                 device: DeviceLike = None, use_kernel: bool = True):
        super().__init__()
        gen = _generator(generator, device)
        self.cfg = cfg
        self.use_kernel = use_kernel
        d, dt = cfg.d_hidden, cfg.dtype
        self.w_in = _fixed(dense_init(gen, cfg.d_feat, d, dt))
        self.w_nbr = nn.ParameterList()
        self.w_self = nn.ParameterList()
        for _ in cfg.fanouts:
            self.w_nbr.append(_fixed(dense_init(gen, d, d, dt)))
            self.w_self.append(_fixed(dense_init(gen, d, d, dt)))
        self.w_out = _fixed(dense_init(gen, d, cfg.n_classes, dt))

    def param_tree(self) -> Dict:
        """The reference's ``{"w_in", "w_nbr": [...], "w_self": [...], "w_out"}``."""
        return {"w_in": self.w_in, "w_nbr": list(self.w_nbr), "w_self": list(self.w_self),
                "w_out": self.w_out}

    def forward(self, feats: torch.Tensor, hops: Sequence) -> torch.Tensor:
        """Logits ``(B, n_classes)`` of the seeds.

        ``hops[k] = (frontier (B_k,), nbr (B_k, fanout), mask)``, local
        indices into ``feats`` (:func:`~repro_torch.graph.sampler.relabel_to_local`),
        or the :class:`SageHop` s :func:`sage_hops` built from them; hop 0
        expands the seeds.  The deepest hop runs first, so each reads the
        previous depth's output."""
        return sage_forward(self.param_tree(), feats, hops, use_kernel=self.use_kernel)


class SageHop(NamedTuple):
    """One sampled hop as B4 takes it: the frontier (int64), the padded
    neighbours (int32), the weights ``mask / max(count, 1)`` and the
    transpose (None when no gradient is taken through the hop)."""

    frontier: torch.Tensor
    nbr: torch.Tensor
    wgt: torch.Tensor
    transpose: Optional[CSRTranspose]


def _sage_hop(hop, dtype, num_nodes: Optional[int]) -> SageHop:
    if isinstance(hop, SageHop):
        return hop
    frontier, nbr, mask = hop
    m = mask.to(dtype)
    wgt = (m / m.sum(dim=1, keepdim=True).clamp(min=1.0)).contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    t = None if num_nodes is None else transpose_padded_csr(nbr, wgt, num_nodes)
    return SageHop(frontier.long(), nbr, wgt, t)


def sage_hops(hops: Sequence[Hop], num_nodes: int):
    """Each raw hop ``(frontier, nbr, mask)`` as a :class:`SageHop` (f32
    weights) with its transposed operator over the ``num_nodes`` local
    nodes: built once per sampled batch, the train step's input."""
    return [_sage_hop(h, torch.float32, num_nodes) for h in hops]


def sage_forward(params: Dict, feats: torch.Tensor, hops: Sequence, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """SAGE over its parameter tree (``SAGE.forward``'s function)."""
    h = torch.relu(feats @ params["w_in"])
    hops = [_sage_hop(hop, h.dtype, None) for hop in hops]
    for hop, w, ws in zip(reversed(hops), params["w_nbr"], params["w_self"]):
        if use_kernel:
            mean = _aggregate(hop.nbr, hop.wgt, h, None, hop.transpose)
        else:
            mean = csr_aggregate_ref(hop.nbr, hop.wgt, h)
        out = torch.relu(mean @ w + h[hop.frontier] @ ws)
        h = h.index_copy(0, hop.frontier, out)
    return h[hops[0].frontier] @ params["w_out"]


__all__ = [
    "CSROperator",
    "DimeNet",
    "DimeNetConfig",
    "GAT",
    "GATConfig",
    "GAT_EDGE_CHUNK",
    "GCN",
    "GCNConfig",
    "MGNConfig",
    "MeshGraphNet",
    "SAGE",
    "SageConfig",
    "SageHop",
    "build_triplets",
    "csr_operator",
    "dimenet_forward",
    "gat_forward",
    "gcn_adjacency",
    "gcn_adjacency_live",
    "gcn_forward",
    "gcn_forward_csr",
    "gcn_operator",
    "mgn_forward",
    "sage_forward",
    "sage_hops",
]
