"""Heterogeneous network container.

The paper's network (Fig. 1) has T node types (drug / disease / target in the
case study, T=3 but the container is generic), with

* ``P[i]``   — an ``(n_i, n_i)`` similarity (proximity) matrix per type, and
* ``R[(i,j)]`` — an ``(n_i, n_j)`` binary association matrix per type pair.

Node ids are globally flattened by concatenating types: type ``i`` occupies
rows ``[offset[i], offset[i] + n_i)``.  (The paper instead interleaves ids as
``3x + i`` so a Giraph vertex can recover its type with ``id % 3``; with
tensorized storage the block layout carries the same information and keeps
every block contiguous, which is what the MXU wants.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.normalize import bipartite_normalize, symmetric_normalize

TypePair = Tuple[int, int]


def _as_f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass
class HeteroNetwork:
    """A heterogeneous network: T homogeneous nets + inter-type associations.

    Attributes:
      P: list of per-type similarity matrices, ``P[i]: (n_i, n_i)``,
         nonnegative, assumed symmetric (symmetrized on construction).
      R: dict mapping ``(i, j)`` with ``i < j`` to the ``(n_i, n_j)``
         association matrix.
      type_names: optional human names per type (e.g. drug/disease/target).
    """

    P: List[np.ndarray]
    R: Dict[TypePair, np.ndarray]
    type_names: Optional[Sequence[str]] = None

    def __post_init__(self) -> None:
        self.P = [_as_f64(p) for p in self.P]
        canon: Dict[TypePair, np.ndarray] = {}
        for (i, j), r in self.R.items():
            r = _as_f64(r)
            if i == j:
                raise ValueError(f"R[{(i, j)}] must connect two distinct types")
            if i > j:  # canonicalize to i < j
                i, j, r = j, i, r.T
            if (i, j) in canon:
                raise ValueError(f"duplicate association block {(i, j)}")
            canon[(i, j)] = r
        self.R = canon
        for i, p in enumerate(self.P):
            if p.ndim != 2 or p.shape[0] != p.shape[1]:
                raise ValueError(f"P[{i}] must be square, got {p.shape}")
            # Similarity must be symmetric for the convergence proof; enforce.
            self.P[i] = (p + p.T) / 2.0
        for (i, j), r in self.R.items():
            want = (self.P[i].shape[0], self.P[j].shape[0])
            if r.shape != want:
                raise ValueError(f"R[{(i, j)}] shape {r.shape} != {want}")
        if self.type_names is not None and len(self.type_names) != self.num_types:
            raise ValueError("type_names length mismatch")

    # ---------------------------------------------------------------- sizes
    @property
    def num_types(self) -> int:
        return len(self.P)

    @property
    def sizes(self) -> List[int]:
        return [p.shape[0] for p in self.P]

    @property
    def num_nodes(self) -> int:
        return int(sum(self.sizes))

    @property
    def offsets(self) -> List[int]:
        out, acc = [], 0
        for n in self.sizes:
            out.append(acc)
            acc += n
        return out

    @property
    def num_edges(self) -> int:
        """Count of nonzero (undirected) entries, paper's |E| convention."""
        total = 0
        for p in self.P:
            total += int(np.count_nonzero(p))
        for r in self.R.values():
            total += 2 * int(np.count_nonzero(r))
        return total

    def type_of_node(self) -> np.ndarray:
        """Global-node-id -> type-id vector (the ``id % 3`` analogue)."""
        out = np.empty(self.num_nodes, dtype=np.int32)
        for i, (off, n) in enumerate(zip(self.offsets, self.sizes)):
            out[off : off + n] = i
        return out

    def block_slices(self) -> List[slice]:
        return [slice(off, off + n) for off, n in zip(self.offsets, self.sizes)]

    # -------------------------------------------------------------- storage
    def save_npz(self, path: str) -> str:
        """Write the network to one ``.npz`` (``NetworkSpec(kind='file')``).

        Layout: ``P_<t>`` per similarity block, ``R_<i>_<j>`` per
        association block, optional ``type_names``.  Returns the path
        actually written — numpy appends ``.npz`` when missing, and a
        return value that :meth:`load_npz` cannot open would be a trap.
        """
        arrays: Dict[str, np.ndarray] = {
            f"P_{t}": p for t, p in enumerate(self.P)
        }
        for (i, j), r in self.R.items():
            arrays[f"R_{i}_{j}"] = r
        if self.type_names is not None:
            arrays["type_names"] = np.asarray(list(self.type_names))
        np.savez_compressed(path, **arrays)
        return path if path.endswith(".npz") else path + ".npz"

    @classmethod
    def load_npz(cls, path: str) -> "HeteroNetwork":
        """Inverse of :meth:`save_npz`."""
        with np.load(path, allow_pickle=False) as data:
            p_keys = sorted(
                (k for k in data.files if k.startswith("P_")),
                key=lambda k: int(k.split("_")[1]),
            )
            if not p_keys:
                raise ValueError(f"{path}: no P_<t> similarity blocks found")
            P = [data[k] for k in p_keys]
            R = {}
            for k in data.files:
                if k.startswith("R_"):
                    _, i, j = k.split("_")
                    R[(int(i), int(j))] = data[k]
            names = (
                tuple(str(s) for s in data["type_names"])
                if "type_names" in data.files
                else None
            )
        return cls(P=P, R=R, type_names=names)

    # ----------------------------------------------------------- transforms
    def normalize(self) -> "NormalizedNetwork":
        """Paper §3.1: normalize all P_i and R_ij so LP converges."""
        S_homo = [symmetric_normalize(p) for p in self.P]
        S_het = {k: bipartite_normalize(r) for k, r in self.R.items()}
        return NormalizedNetwork(
            S_homo=S_homo,
            S_het=S_het,
            sizes=self.sizes,
            type_names=self.type_names,
        )

    def apply_delta(self, delta: "GraphDelta") -> "HeteroNetwork":
        """Return a new network with ``delta``'s edits applied.

        The serving layer (``repro/serve``) uses this as its incremental
        update path: apply, bump the network version, invalidate cached
        label columns whose types the delta touches, and warm-start the
        re-solve from the stale columns (DESIGN.md §9).
        """
        P = [p.copy() for p in self.P]
        R = {k: v.copy() for k, v in self.R.items()}

        # 1. grow blocks first so subsequent edge edits may target new nodes
        for t, count in sorted(delta.add_nodes.items()):
            if not 0 <= t < len(P):
                raise ValueError(f"add_nodes: no such type {t}")
            if count < 0:
                raise ValueError("add_nodes count must be >= 0")
            n_old = P[t].shape[0]
            grown = np.zeros((n_old + count, n_old + count), dtype=np.float64)
            grown[:n_old, :n_old] = P[t]
            P[t] = grown
            for (i, j) in list(R):
                r = R[(i, j)]
                if i == t:
                    R[(i, j)] = np.concatenate(
                        [r, np.zeros((count, r.shape[1]))], axis=0
                    )
                elif j == t:
                    R[(i, j)] = np.concatenate(
                        [r, np.zeros((r.shape[0], count))], axis=1
                    )

        # 2. similarity edits (kept symmetric; weight 0 removes the edge)
        for t, u, v, w in delta.sim:
            if not 0 <= t < len(P):
                raise ValueError(f"sim edit: no such type {t}")
            n = P[t].shape[0]
            if not (0 <= u < n and 0 <= v < n):
                raise ValueError(
                    f"sim edit ({u}, {v}) out of range for type {t} (n={n})"
                )
            P[t][u, v] = w
            P[t][v, u] = w

        # 3. association edits (weight 0 removes the edge)
        for pair, u, v, w in delta.assoc:
            i, j = min(pair), max(pair)
            if pair[0] > pair[1]:
                u, v = v, u
            if (i, j) not in R:
                if not (0 <= i < len(P) and 0 <= j < len(P)):
                    raise ValueError(f"assoc edit: no such pair {pair}")
                R[(i, j)] = np.zeros((P[i].shape[0], P[j].shape[0]))
            r = R[(i, j)]
            if not (0 <= u < r.shape[0] and 0 <= v < r.shape[1]):
                raise ValueError(
                    f"assoc edit ({u}, {v}) out of range for {r.shape}"
                )
            r[u, v] = w

        return HeteroNetwork(P=P, R=R, type_names=self.type_names)

    def with_masked_fold(
        self, pair: TypePair, mask: np.ndarray
    ) -> "HeteroNetwork":
        """Return a copy with the given association entries zeroed.

        Used by k-fold CV (paper §6.2.1) and the recovery protocol:
        ``mask`` is a boolean array over ``R[pair]`` marking held-out
        entries.
        """
        i, j = min(pair), max(pair)
        R = {k: v.copy() for k, v in self.R.items()}
        R[(i, j)] = np.where(mask, 0.0, R[(i, j)])
        return HeteroNetwork(
            P=[p.copy() for p in self.P], R=R, type_names=self.type_names
        )


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of edits to a :class:`HeteroNetwork` (the online-update unit).

    Attributes:
      assoc: ``(pair, row, col, weight)`` association edits; ``row``/``col``
        are local indices within the pair's blocks and ``weight == 0``
        removes the edge.  Pairs are given in either orientation.
      sim: ``(type, u, v, weight)`` similarity edits (applied symmetrically).
      add_nodes: ``{type: count}`` — append ``count`` isolated nodes to the
        end of the type's block (no re-indexing of existing nodes).
    """

    assoc: Tuple[Tuple[TypePair, int, int, float], ...] = ()
    sim: Tuple[Tuple[int, int, int, float], ...] = ()
    add_nodes: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(self, "assoc", tuple(tuple(e) for e in self.assoc))
        object.__setattr__(self, "sim", tuple(tuple(e) for e in self.sim))
        object.__setattr__(self, "add_nodes", dict(self.add_nodes))

    @property
    def is_empty(self) -> bool:
        return not (self.assoc or self.sim or self.add_nodes)

    def touched_types(self) -> frozenset:
        """Types whose nodes the delta edits (serving's invalidation set)."""
        out = set()
        for (i, j), _, _, _ in self.assoc:
            out.add(i)
            out.add(j)
        for t, _, _, _ in self.sim:
            out.add(t)
        out.update(self.add_nodes)
        return frozenset(out)


@dataclasses.dataclass
class NormalizedNetwork:
    """Normalized similarity blocks, ready for propagation."""

    S_homo: List[np.ndarray]
    S_het: Dict[TypePair, np.ndarray]
    sizes: List[int]
    type_names: Optional[Sequence[str]] = None

    @property
    def num_types(self) -> int:
        return len(self.S_homo)

    @property
    def num_nodes(self) -> int:
        return int(sum(self.sizes))

    @property
    def offsets(self) -> List[int]:
        out, acc = [], 0
        for n in self.sizes:
            out.append(acc)
            acc += n
        return out

    def block_slices(self) -> List[slice]:
        return [slice(off, off + n) for off, n in zip(self.offsets, self.sizes)]

    # ------------------------------------------------------- dense assembly
    def assemble_dense(self) -> Tuple[np.ndarray, np.ndarray]:
        """Assemble the (N, N) homogeneous operator M and heterogeneous H.

        ``M`` is block-diagonal (within-type propagation), ``H`` holds the
        off-diagonal association blocks (cross-type propagation).  Their
        supports are disjoint; together they are the full propagation
        operator of one BSP superstep.
        """
        n = self.num_nodes
        sl = self.block_slices()
        M = np.zeros((n, n), dtype=np.float64)
        H = np.zeros((n, n), dtype=np.float64)
        for i, s in enumerate(self.S_homo):
            M[sl[i], sl[i]] = s
        for (i, j), s in self.S_het.items():
            H[sl[i], sl[j]] = s
            H[sl[j], sl[i]] = s.T
        return H, M

    # --------------------------------------------------------- COO assembly
    def to_coo(self) -> "HeteroCOO":
        H, M = self.assemble_dense()
        return HeteroCOO.from_dense(H, M, sizes=self.sizes)


@dataclasses.dataclass
class HeteroCOO:
    """COO edge-list view (the scalable/sparse engine's input).

    Homo and hetero edge sets are kept separate because DHLP mixes them with
    different coefficients.  Edges are stored destination-major so a
    segment-sum over ``dst`` is a contiguous reduce-by-key — the tensorized
    equivalent of Giraph delivering all messages addressed to a vertex in one
    superstep.
    """

    het_src: np.ndarray  # (E_h,) int32 — message source (column index)
    het_dst: np.ndarray  # (E_h,) int32 — message destination (row index)
    het_w: np.ndarray  # (E_h,) float — normalized weight
    hom_src: np.ndarray
    hom_dst: np.ndarray
    hom_w: np.ndarray
    num_nodes: int
    sizes: List[int]

    @classmethod
    def from_dense(
        cls, H: np.ndarray, M: np.ndarray, sizes: Sequence[int]
    ) -> "HeteroCOO":
        def _coo(a: np.ndarray):
            dst, src = np.nonzero(a)  # row=dst receives from col=src
            order = np.argsort(dst, kind="stable")
            dst, src = dst[order], src[order]
            return (
                src.astype(np.int32),
                dst.astype(np.int32),
                a[dst, src].astype(np.float64),
            )

        hs, hd, hw = _coo(H)
        ms, md, mw = _coo(M)
        return cls(
            het_src=hs,
            het_dst=hd,
            het_w=hw,
            hom_src=ms,
            hom_dst=md,
            hom_w=mw,
            num_nodes=int(H.shape[0]),
            sizes=list(sizes),
        )

    @property
    def num_edges(self) -> int:
        return int(self.het_src.shape[0] + self.hom_src.shape[0])


def seeds_identity(num_nodes: int) -> np.ndarray:
    """All-sources seed matrix: Y = I_N.

    The paper sweeps seeds one at a time (``y=1`` for a single vertex per
    sweep); the batched engines treat each seed as a column of Y.
    """
    return np.eye(num_nodes, dtype=np.float64)


def seeds_for_nodes(num_nodes: int, nodes: Sequence[int]) -> np.ndarray:
    y = np.zeros((num_nodes, len(nodes)), dtype=np.float64)
    for c, v in enumerate(nodes):
        y[v, c] = 1.0
    return y


def from_numpy(
    P: Sequence[np.ndarray],
    R: Mapping[TypePair, np.ndarray],
    type_names: Optional[Sequence[str]] = None,
) -> HeteroNetwork:
    """Build this package's :class:`HeteroNetwork` from plain arrays.

    The hand-over point for a network built elsewhere (for example by the
    JAX package, whose ``HeteroNetwork`` holds the same ``P``/``R`` numpy
    blocks): both sides then normalize and assemble their operators from
    identical inputs.  ``.npz`` files written by either package load in
    the other through :meth:`HeteroNetwork.load_npz`.
    """
    return HeteroNetwork(
        P=[np.asarray(p) for p in P],
        R={tuple(k): np.asarray(v) for k, v in R.items()},
        type_names=None if type_names is None else tuple(type_names),
    )
