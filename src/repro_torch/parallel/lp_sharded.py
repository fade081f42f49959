"""Distributed LP over a ``torch.distributed`` device mesh.

2-D decomposition (DESIGN.md §6), one rank per mesh device:

* seed columns sharded over the ``data`` axis: columns are independent
  propagations, so this axis needs no communication inside the loop (the
  Giraph analogue is disjoint seed sweeps on disjoint workers);
* edges sharded over the ``model`` axis: each rank owns E/k edges,
  computes a partial aggregate for ALL nodes, and an all-reduce over the
  edge axis completes the superstep (the Giraph analogue is workers
  exchanging messages at the superstep barrier).

Per-rank state: F of shape (N, s / data).  Per-round wire traffic: one
all-reduce of (N, s / data) over the ``model`` group, plus a one-element
MAX all-reduce of "any column still active" over the whole world, so every
rank agrees on the loop's trip count (ranks that disagreed would wait in
a collective forever).

The local aggregate is a gather, a multiply and an ``index_add_``
(:func:`repro_torch.graph.segment.segment_sum`), as the reference's
``segment_sum``, taken a chunk of label columns at a time so the (E, c)
message panel stays under ``MESSAGE_BUDGET`` elements.

Straggler mitigation (beyond-paper): ``stale_sync=k`` refreshes the remote
contribution every k rounds only; between refreshes a rank iterates with
its own edges live and the others' aggregates stale.  For a contraction
mapping this still converges, and it cuts the collective term by ~k×.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.blocked_csr import (
    blocked_csr_from_network,
    split_blocked_csr_from_network,
)
from repro_torch.core.network import NormalizedNetwork
from repro_torch.core.solver import LPConfig, SolveResult
from repro_torch.device import to_numpy_f64
from repro_torch.graph.segment import segment_sum
from repro_torch.parallel.collectives import compressed_psum
from repro_torch.parallel.mesh import axis_size

#: elements of one (E, c) message panel of the local aggregate
MESSAGE_BUDGET = 1 << 27


@dataclasses.dataclass
class ShardedLPArrays:
    """Host-side prepared arrays: edge shards stacked on a leading axis."""

    src: np.ndarray  # (k, Ep) int32 — fused operator edges
    dst: np.ndarray  # (k, Ep) int32
    w: np.ndarray  # (k, Ep) float32 (pre-scaled: αβ·scale·het ∪ α·hom)
    num_nodes: int
    beta2: float


def _shard_edges(src, dst, w, num_edge_shards: int):
    """Slice a destination-sorted edge triple into k equal shards.

    Inputs come from ``BlockedCSR.to_edges(include_pads=False)``: slots
    are row-major (dst non-decreasing) with the zero-weight tile padding
    dropped, so equal slices are destination-contiguous and a shard's
    aggregate never touches pad slots.  The tail pads with weight-0 edges
    into node 0.
    """
    e = src.shape[0]
    per = max(1, -(-e // num_edge_shards))
    pad = per * num_edge_shards - e
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    w = np.concatenate([w.astype(np.float32), np.zeros(pad, np.float32)])
    return (
        src.reshape(num_edge_shards, per),
        dst.reshape(num_edge_shards, per),
        w.reshape(num_edge_shards, per),
    )


def prepare_sharded_operator(
    norm: NormalizedNetwork, cfg: LPConfig, num_edge_shards: int
) -> ShardedLPArrays:
    """Fused DHLP-2 operator as edge shards, derived from blocked-CSR: the
    shards are flat slices of the operator the sparse/kernel engines
    aggregate."""
    scale = cfg.resolved_hetero_scale(norm.num_types)
    beta = 1.0 - cfg.alpha
    bcsr = blocked_csr_from_network(norm, alpha=cfg.alpha, hetero_scale=scale)
    src, dst, w = _shard_edges(*bcsr.to_edges(include_pads=False), num_edge_shards)
    return ShardedLPArrays(
        src=src, dst=dst, w=w, num_nodes=norm.num_nodes, beta2=beta * beta
    )


def _prepare_split_operator(
    norm: NormalizedNetwork, cfg: LPConfig, num_edge_shards: int
):
    """Hetero and homo edge shards (scaled) from the blocked-CSR pair the
    sparse engine's DHLP-1 buckets aggregate."""
    scale = cfg.resolved_hetero_scale(norm.num_types)
    het_csr, hom_csr = split_blocked_csr_from_network(norm, hetero_scale=scale)
    het = _shard_edges(*het_csr.to_edges(include_pads=False), num_edge_shards)
    hom = _shard_edges(*hom_csr.to_edges(include_pads=False), num_edge_shards)
    return het, hom


def local_aggregate(src, dst, w, F, num_nodes: int) -> torch.Tensor:
    """This rank's partial ``A_shard @ F`` for all nodes, in column chunks."""
    e = max(1, src.shape[0])
    s = F.shape[1]
    cols = max(1, min(s, MESSAGE_BUDGET // e))
    if cols >= s:
        return segment_sum(w[:, None] * F[src], dst, num_nodes)
    out = torch.empty((num_nodes, s), dtype=F.dtype, device=F.device)
    for c0 in range(0, s, cols):
        out[:, c0 : c0 + cols] = segment_sum(
            w[:, None] * F[src, c0 : c0 + cols], dst, num_nodes
        )
    return out


@dataclasses.dataclass
class ShardedPrepared:
    """This rank's device-resident operator shards for one mesh."""

    mesh: object
    num_nodes: int
    arrays: Tuple[torch.Tensor, ...]
    alg: str
    edge_axis: str
    seed_axis: str
    device: torch.device
    beta2: float


class _Comm:
    """The groups one prepared operator reduces over, and the generator
    int8 compression rounds with."""

    def __init__(self, prep: ShardedPrepared, compression: str):
        self.edge_group = prep.mesh.get_group(prep.edge_axis)
        self.seed_group = prep.mesh.get_group(prep.seed_axis)
        self.compression = compression
        self.generator = None
        if compression == "int8":
            self.generator = torch.Generator(device=prep.device)
            self.generator.manual_seed(1234 + dist.get_rank())

    def psum(self, local: torch.Tensor) -> torch.Tensor:
        return compressed_psum(
            local, self.edge_group, compression=self.compression, generator=self.generator
        )

    def any_active(self, active: torch.Tensor) -> bool:
        """The world's "any column still active": the same on every rank."""
        flag = active.any().to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every seed shard's columns (the last axis)."""
        k = dist.get_world_size(self.seed_group)
        if k == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(k)]
        dist.all_gather(parts, x.contiguous(), group=self.seed_group)
        return torch.cat(parts, dim=-1)


def _dhlp2_loop(prep, comm, Y, F0, *, sigma, max_iter, seed_mode, stale_sync):
    """Sharded DHLP-2 on this rank's edges and columns."""
    src, dst, w = prep.arrays
    n = prep.num_nodes
    F = F0
    s = Y.shape[1]
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    col_iters = torch.zeros(s, dtype=torch.int32, device=Y.device)
    remote = torch.zeros_like(F)
    it = 0
    going = True
    while it < max_iter and going:
        base = Y if seed_mode == "fixed" else F
        local = local_aggregate(src, dst, w, F, n)
        if stale_sync <= 1:
            agg = comm.psum(local)
        else:
            # the switch is a function of `it`, the same on every rank
            if it % stale_sync == 0:
                remote = comm.psum(local) - local
            agg = local + remote
        Fn = prep.beta2 * base + agg
        Fn = torch.where(active[None, :], Fn, F)
        delta = (Fn - F).abs().amax(dim=0)
        still = active & ~(delta < sigma)
        col_iters += active.int()
        going = comm.any_active(still)
        F, active = Fn, still
        it += 1
    return F, it, col_iters


def _dhlp1_loop(prep, comm, Y, F0, *, alpha, sigma, max_iter, max_inner, seed_mode):
    """Sharded DHLP-1: outer hetero injection + inner homogeneous solve,
    both loops on world-uniform predicates."""
    h_src, h_dst, h_w, m_src, m_dst, m_w = prep.arrays
    n = prep.num_nodes
    beta = 1.0 - alpha
    F = F0
    s = Y.shape[1]
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    it = tot_inner = 0
    going = True
    while it < max_iter and going:
        src_lbl = Y if seed_mode == "fixed" else F
        Yp = beta * src_lbl + alpha * comm.psum(local_aggregate(h_src, h_dst, h_w, F, n))
        Fi, iact, inner_it, igoing = F, active, 0, True
        while inner_it < max_inner and igoing:
            Fn = beta * Yp + alpha * comm.psum(local_aggregate(m_src, m_dst, m_w, Fi, n))
            Fn = torch.where(iact[None, :], Fn, Fi)
            delta = (Fn - Fi).abs().amax(dim=0)
            iact = iact & ~(delta < sigma)
            igoing = comm.any_active(iact)
            Fi = Fn
            inner_it += 1
        Fn = torch.where(active[None, :], Fi, F)
        delta = (Fn - F).abs().amax(dim=0)
        still = active & ~(delta < sigma)
        going = comm.any_active(still)
        F, active = Fn, still
        it += 1
        tot_inner += inner_it
    return F, it, tot_inner


class ShardedHeteroLP:
    """Distributed solver on an explicit device mesh (every rank of the
    mesh calls each method with the same arguments)."""

    def __init__(
        self,
        config: LPConfig = LPConfig(),
        *,
        stale_sync: int = 1,
        compression: str = "none",
        device=None,
    ):
        if compression not in ("none", "bf16", "int8"):
            raise ValueError(f"unknown compression {compression!r}")
        self.config = config
        self.stale_sync = stale_sync
        self.compression = compression
        self.device = device
        self._prep_cache: Optional[Tuple[object, object, ShardedPrepared]] = None

    def _device(self, mesh) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def prepare(
        self,
        norm: NormalizedNetwork,
        mesh,
        *,
        edge_axis: str = "model",
        seed_axis: str = "data",
    ) -> ShardedPrepared:
        """Shard the operator and upload this rank's shard once per
        (network, mesh, axes); repeat solves skip the upload."""
        cache = self._prep_cache
        if (
            cache is not None
            and cache[0] is norm
            and cache[1] is mesh
            and cache[2].edge_axis == edge_axis
            and cache[2].seed_axis == seed_axis
        ):
            return cache[2]
        cfg = self.config
        k_edges = axis_size(mesh, edge_axis)
        me = mesh.get_local_rank(edge_axis)
        dev = self._device(mesh)
        beta = 1.0 - cfg.alpha

        def shard(src, dst, w):
            return (
                torch.as_tensor(src[me].astype(np.int64), device=dev),
                torch.as_tensor(dst[me].astype(np.int64), device=dev),
                torch.as_tensor(w[me], dtype=torch.float32, device=dev),
            )

        if cfg.alg == "dhlp1":
            het, hom = _prepare_split_operator(norm, cfg, k_edges)
            arrays = shard(*het) + shard(*hom)
        else:
            arrs = prepare_sharded_operator(norm, cfg, k_edges)
            arrays = shard(arrs.src, arrs.dst, arrs.w)
        prep = ShardedPrepared(
            mesh=mesh,
            num_nodes=norm.num_nodes,
            arrays=arrays,
            alg=cfg.alg,
            edge_axis=edge_axis,
            seed_axis=seed_axis,
            device=dev,
            beta2=beta * beta,
        )
        self._prep_cache = (norm, mesh, prep)
        return prep

    def _local_columns(self, prep: ShardedPrepared, X: np.ndarray) -> torch.Tensor:
        """This rank's seed shard of ``X`` (N, s_pad) as f32 on its device."""
        k = axis_size(prep.mesh, prep.seed_axis)
        d = prep.mesh.get_local_rank(prep.seed_axis)
        per = X.shape[1] // k
        return torch.as_tensor(
            np.ascontiguousarray(X[:, d * per : (d + 1) * per]),
            dtype=torch.float32,
            device=prep.device,
        )

    @staticmethod
    def _pad(X: np.ndarray, k: int) -> np.ndarray:
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        pad = (-X.shape[1]) % k
        if pad:
            X = np.concatenate([X, np.zeros((X.shape[0], pad), X.dtype)], axis=1)
        return X

    def solve_prepared(
        self,
        prep: ShardedPrepared,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        cfg = self.config
        k_seeds = axis_size(prep.mesh, prep.seed_axis)
        Y = np.asarray(Y)
        s = Y.shape[1] if Y.ndim == 2 else 1
        Yp = self._pad(Y, k_seeds)
        F0p = Yp if F0 is None else self._pad(F0, k_seeds)
        Yd = self._local_columns(prep, Yp)
        F0d = self._local_columns(prep, F0p)
        comm = _Comm(prep, self.compression)
        common = dict(
            sigma=cfg.sigma, max_iter=cfg.max_iter, seed_mode=cfg.resolved_seed_mode()
        )
        if prep.alg == "dhlp1":
            F, outer, tot_inner = _dhlp1_loop(
                prep, comm, Yd, F0d, alpha=cfg.alpha, max_inner=cfg.max_inner, **common
            )
            return SolveResult(
                F=to_numpy_f64(comm.gather_columns(F))[:, :s],
                outer_iters=outer,
                inner_iters=tot_inner,
                converged=bool(outer < cfg.max_iter),
            )
        F, outer, col_iters = _dhlp2_loop(
            prep, comm, Yd, F0d, stale_sync=self.stale_sync, **common
        )
        return SolveResult(
            F=to_numpy_f64(comm.gather_columns(F))[:, :s],
            outer_iters=outer,
            inner_iters=0,
            converged=bool(outer < cfg.max_iter),
            per_column_iters=comm.gather_columns(col_iters).cpu().numpy()[:s],
        )

    def round(self, prep: ShardedPrepared, F: np.ndarray, Y: np.ndarray) -> np.ndarray:
        """One fused fixed-seed DHLP-2 round ``β²Y + A_eff @ F`` on a
        DHLP-2 operator's shards (serve's refresh unit): the same
        aggregate and all-reduce as one superstep."""
        if prep.alg != "dhlp2":
            raise ValueError("round needs the fused DHLP-2 operator shards")
        k_seeds = axis_size(prep.mesh, prep.seed_axis)
        F = np.asarray(F, np.float32)
        s = F.shape[1] if F.ndim == 2 else 1
        Fd = self._local_columns(prep, self._pad(F, k_seeds))
        Yd = self._local_columns(prep, self._pad(np.asarray(Y, np.float32), k_seeds))
        comm = _Comm(prep, self.compression)
        src, dst, w = prep.arrays
        out = prep.beta2 * Yd + comm.psum(local_aggregate(src, dst, w, Fd, prep.num_nodes))
        return to_numpy_f64(comm.gather_columns(out))[:, :s]

    def run(
        self,
        norm: NormalizedNetwork,
        mesh,
        seeds: Optional[np.ndarray] = None,
        *,
        edge_axis: str = "model",
        seed_axis: str = "data",
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        n = norm.num_nodes
        Y = np.eye(n, dtype=np.float32) if seeds is None else seeds
        prep = self.prepare(norm, mesh, edge_axis=edge_axis, seed_axis=seed_axis)
        return self.solve_prepared(prep, Y, F0=F0)


__all__ = [
    "MESSAGE_BUDGET",
    "ShardedHeteroLP",
    "ShardedLPArrays",
    "ShardedPrepared",
    "local_aggregate",
    "prepare_sharded_operator",
]
