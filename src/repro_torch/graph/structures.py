"""Graph containers and generators: COO edge lists and padded CSR.

The port's copy of ``repro.graph.structures``: the same dataclasses over
the same numpy arrays, and the same generators (``erdos_renyi``,
``powerlaw_graph``: the same numpy draws), bit for bit.

* ``EdgeList`` (COO) is the exchange format, stored destination-major so
  segment reductions see sorted ids.
* ``PaddedCSR`` re-packs neighbours into an ``(N, max_deg)`` rectangle —
  the ``(nbr, wgt)`` input of the ``csr_aggregate`` kernel; the pad
  entries point at node 0 with weight 0 so every op treats them as no-ops.
* All index arrays are int32.

The heavy steps (the stable sort by destination, the deduplication of
``symmetrized`` and the packing of ``PaddedCSR``) run as torch ops on
``device`` (``cuda:0`` unless the caller asks for the CPU): at
``ogb_products`` size (126 M edges) numpy's sort takes minutes on the
host.  A stable sort gives the same order on any device, so the arrays
are those of the reference.  The generators draw on the host with numpy
and sort on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _to(dev: torch.device, *arrays: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclasses.dataclass
class EdgeList:
    """COO graph: edge e carries ``src[e] -> dst[e]`` with weight ``w[e]``."""

    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    w: Optional[np.ndarray]  # (E,) float32 or None (unweighted)
    num_nodes: int

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.w is not None:
            self.w = np.asarray(self.w, dtype=np.float32)
            if self.w.shape != self.src.shape:
                raise ValueError("w shape mismatch")
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def weights(self) -> np.ndarray:
        if self.w is None:
            return np.ones_like(self.src, dtype=np.float32)
        return self.w

    # ----------------------------------------------------------- transforms
    def sorted_by_dst(self, device: DeviceLike = None) -> "EdgeList":
        """The edges in stable destination order (the sort on ``device``)."""
        dev = resolve_device(device)
        src, dst = _to(dev, self.src, self.dst)
        order = torch.sort(dst, stable=True).indices
        w = None if self.w is None else _host(_to(dev, self.w)[0][order])
        return EdgeList(
            src=_host(src[order]), dst=_host(dst[order]), w=w, num_nodes=self.num_nodes
        )

    def symmetrized(self, device: DeviceLike = None) -> "EdgeList":
        """Add reverse edges (deduplicated; the first copy of a pair wins)."""
        src, dst, w = _to(resolve_device(device), self.src, self.dst, self.weights())
        s2 = torch.cat([src, dst])
        d2 = torch.cat([dst, src])
        key = s2.long() * self.num_nodes + d2.long()
        sorted_key, order = torch.sort(key, stable=True)
        first = torch.ones_like(sorted_key, dtype=torch.bool)
        first[1:] = sorted_key[1:] != sorted_key[:-1]
        idx = order[first]  # np.unique(key, return_index=True)[1]
        return EdgeList(
            src=_host(s2[idx]), dst=_host(d2[idx]), w=_host(torch.cat([w, w])[idx]),
            num_nodes=self.num_nodes,
        )

    def with_self_loops(self) -> "EdgeList":
        loops = np.arange(self.num_nodes, dtype=np.int32)
        return EdgeList(
            src=np.concatenate([self.src, loops]),
            dst=np.concatenate([self.dst, loops]),
            w=np.concatenate([self.weights(), np.ones(self.num_nodes, np.float32)]),
            num_nodes=self.num_nodes,
        )

    def pad_to_multiple(self, mult: int) -> "EdgeList":
        """Pad with zero-weight self-loops on node 0 (shard-friendly shapes)."""
        e = self.num_edges
        target = ((e + mult - 1) // mult) * mult if e else mult
        pad = target - e
        if pad == 0 and self.w is not None:
            return self
        return EdgeList(
            src=np.concatenate([self.src, np.zeros(pad, np.int32)]),
            dst=np.concatenate([self.dst, np.zeros(pad, np.int32)]),
            w=np.concatenate([self.weights(), np.zeros(pad, np.float32)]),
            num_nodes=self.num_nodes,
        )

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_nodes)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_nodes)

    # ------------------------------------------------------------- builders
    @classmethod
    def from_dense(cls, A: np.ndarray) -> "EdgeList":
        # np.nonzero walks A row-major: already sorted by dst (stably)
        dst, src = np.nonzero(A)
        return cls(
            src=src.astype(np.int32),
            dst=dst.astype(np.int32),
            w=A[dst, src].astype(np.float32),
            num_nodes=A.shape[0],
        )

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)
        np.add.at(A, (self.dst, self.src), self.weights())
        return A

    def to_padded_csr(self, max_deg: Optional[int] = None, device: DeviceLike = None) -> "PaddedCSR":
        return PaddedCSR.from_edgelist(self, max_deg=max_deg, device=device)


def padded_csr_tensors(
    src: torch.Tensor,  # (E,) int32
    dst: torch.Tensor,  # (E,) int32
    w: torch.Tensor,  # (E,) float32
    num_nodes: int,
    max_deg: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack a COO graph into ``(nbr, wgt, deg)`` on the edges' device.

    ``nbr[v, k]`` / ``wgt[v, k]`` are v's k-th in-neighbour and its weight
    in stable destination order; pads are ``(0, 0.0)``; ``deg`` is the
    true in-degree (it may exceed ``max_deg``, whose rows are truncated).
    """
    dev = dst.device
    order = torch.sort(dst, stable=True).indices
    d = dst[order].long()
    deg = torch.bincount(d, minlength=num_nodes)
    cap = int(deg.max()) if d.numel() else 1
    cap = max(cap if max_deg is None else int(max_deg), 1)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(d.numel(), device=dev) - starts[d]
    keep = slot < cap
    nbr = torch.zeros((num_nodes, cap), dtype=torch.int32, device=dev)
    wgt = torch.zeros((num_nodes, cap), dtype=torch.float32, device=dev)
    nbr[d[keep], slot[keep]] = src[order][keep]
    wgt[d[keep], slot[keep]] = w[order][keep].float()
    return nbr, wgt, deg.int()


@dataclasses.dataclass
class PaddedCSR:
    """Destination-indexed padded neighbour table.

    ``nbr[v, k]`` is the k-th in-neighbour of v (source node of an incoming
    edge), ``wgt[v, k]`` its weight; pads are (0, 0.0).
    """

    nbr: np.ndarray  # (N, max_deg) int32
    wgt: np.ndarray  # (N, max_deg) float32
    deg: np.ndarray  # (N,) int32 true in-degree (may exceed max_deg if truncated)
    num_nodes: int

    @property
    def max_deg(self) -> int:
        return int(self.nbr.shape[1])

    @classmethod
    def from_edgelist(
        cls, edges: EdgeList, max_deg: Optional[int] = None, device: DeviceLike = None
    ) -> "PaddedCSR":
        src, dst, w = _to(resolve_device(device), edges.src, edges.dst, edges.weights())
        nbr, wgt, deg = padded_csr_tensors(src, dst, w, edges.num_nodes, max_deg)
        return cls(nbr=_host(nbr), wgt=_host(wgt), deg=_host(deg), num_nodes=edges.num_nodes)


def erdos_renyi(
    num_nodes: int,
    num_edges: int,
    seed: int = 0,
    weighted: bool = True,
    device: DeviceLike = None,
) -> EdgeList:
    """Random graph with exactly ``num_edges`` directed edges (repeats kept
    raw), in destination order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    w = rng.random(num_edges).astype(np.float32) if weighted else None
    return EdgeList(src=src, dst=dst, w=w, num_nodes=num_nodes).sorted_by_dst(device)


def powerlaw_graph(
    num_nodes: int,
    num_edges: int,
    exponent: float = 2.1,
    seed: int = 0,
    device: DeviceLike = None,
) -> EdgeList:
    """Degree-skewed graph (realistic for biological/social networks): both
    endpoints drawn with probability ∝ rank^(-exponent/2), node 0 the most
    likely; in destination order."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-exponent / 2.0)
    probs /= probs.sum()
    src = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int32)
    dst = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int32)
    return EdgeList(src=src, dst=dst, w=None, num_nodes=num_nodes).sorted_by_dst(device)


__all__ = ["EdgeList", "PaddedCSR", "erdos_renyi", "padded_csr_tensors", "powerlaw_graph"]
