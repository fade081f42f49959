"""Padded blocked-CSR — the shared sparse operator format (DESIGN.md §11).

The COO/segment-sum layout pays a scatter per superstep and carries one
``(src, dst, w)`` triple per edge.  Blocked-CSR instead groups rows (message
*destinations*) into fixed-size row blocks; each block stores its rows'
in-neighbors in a *fixed-width* rectangle whose width is the block's max
in-degree rounded up to ``width_mult`` slots:

    row_ptr[b]          slot offset of block b's storage
    widths[b]           slots per row inside block b  (multiple of width_mult)
    col_idx[s], val[s]  flat row-major neighbor ids / weights, zero-padded

Two consumers in this package share this one format:

* the ``sparse`` engine (``repro_torch/engine/sparse.py``) re-buckets rows
  by exact width and aggregates per bucket with a gather + einsum — no
  scatter, regular shapes;
* the ``csr_round_residual`` CUDA kernel consumes each bucket's
  ``(rows, width)`` rectangle directly (``kernel`` backend).

Why blocks instead of one uniform rectangle:
on degree-skewed graphs a single ``max_deg``-wide table pads every leaf row
to the hub width; per-block widths keep the padding local to hub blocks
(``padding_ratio`` reports the win).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class WidthBucket:
    """All row blocks sharing one width, stacked into one rectangle.

    ``rows`` are the (true, un-padded) global row ids covered by the bucket;
    ``nbr``/``wgt`` are ``(len(rows), width)`` — the regular tile the
    gather path and the CUDA kernel consume.
    """

    width: int
    rows: np.ndarray  # (R,) int32 global row ids (padding rows dropped)
    nbr: np.ndarray  # (R, width) int32
    wgt: np.ndarray  # (R, width) float32


@dataclasses.dataclass
class BlockedCSR:
    """Padded blocked-CSR operator: ``out[r] = Σ_k val[r,k] · F[col_idx[r,k]]``.

    Rows are grouped into blocks of ``block_rows``; block ``b`` stores
    ``block_rows × widths[b]`` slots starting at ``row_ptr[b]``.  Slots past a
    row's true degree (and rows past ``num_rows`` in the last block) are
    zero-weight pads pointing at column 0 — no-ops under any aggregation.
    """

    col_idx: np.ndarray  # (total_slots,) int32
    val: np.ndarray  # (total_slots,) float32
    row_ptr: np.ndarray  # (num_blocks + 1,) int64 slot offsets
    widths: np.ndarray  # (num_blocks,) int32 slots per row
    block_rows: int
    num_rows: int
    num_cols: int

    # ------------------------------------------------------------ properties
    @property
    def num_blocks(self) -> int:
        return int(self.widths.shape[0])

    @property
    def total_slots(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.val))

    @property
    def padding_ratio(self) -> float:
        """Fraction of stored slots that are pads (lower is better)."""
        slots = max(self.total_slots, 1)
        return 1.0 - self.nnz / slots

    @property
    def max_width(self) -> int:
        return int(self.widths.max(initial=0))

    # -------------------------------------------------------------- builders
    @classmethod
    def from_edges(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        w: np.ndarray,
        *,
        num_rows: int,
        num_cols: Optional[int] = None,
        block_rows: int = 64,
        width_mult: int = 8,
    ) -> "BlockedCSR":
        """Build from a COO triple (``dst`` receives from ``src``).

        Zero-weight edges are dropped (they are COO padding); duplicate
        ``(dst, src)`` entries keep separate slots (aggregation sums them,
        matching segment-sum semantics).
        """
        if block_rows < 1 or width_mult < 1:
            raise ValueError("block_rows and width_mult must be >= 1")
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        w = np.asarray(w, dtype=np.float32)
        keep = w != 0.0
        src, dst, w = src[keep], dst[keep], w[keep]
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]

        num_cols = num_rows if num_cols is None else int(num_cols)
        num_blocks = max(1, -(-num_rows // block_rows))
        deg = np.bincount(dst, minlength=num_rows).astype(np.int64)
        pad_rows = num_blocks * block_rows - num_rows
        deg_blocked = np.concatenate([deg, np.zeros(pad_rows, np.int64)])
        block_max = deg_blocked.reshape(num_blocks, block_rows).max(axis=1)
        widths = (
            np.maximum(
                width_mult,
                ((block_max + width_mult - 1) // width_mult) * width_mult,
            )
        ).astype(np.int32)

        row_ptr = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(widths.astype(np.int64) * block_rows, out=row_ptr[1:])
        col_idx = np.zeros(int(row_ptr[-1]), dtype=np.int32)
        val = np.zeros(int(row_ptr[-1]), dtype=np.float32)

        # slot of edge e = block base + local row offset + rank within row
        starts = np.zeros(num_rows, dtype=np.int64)
        np.cumsum(deg[:-1], out=starts[1:])
        rank = np.arange(dst.shape[0], dtype=np.int64) - starts[dst]
        blk = dst // block_rows
        local = (dst % block_rows).astype(np.int64)
        slot = row_ptr[blk] + local * widths[blk] + rank
        col_idx[slot] = src
        val[slot] = w
        return cls(
            col_idx=col_idx,
            val=val,
            row_ptr=row_ptr,
            widths=widths,
            block_rows=block_rows,
            num_rows=int(num_rows),
            num_cols=num_cols,
        )

    @classmethod
    def from_dense(
        cls,
        A: np.ndarray,
        *,
        block_rows: int = 64,
        width_mult: int = 8,
    ) -> "BlockedCSR":
        dst, src = np.nonzero(A)
        return cls.from_edges(
            src.astype(np.int32),
            dst.astype(np.int32),
            A[dst, src].astype(np.float32),
            num_rows=A.shape[0],
            num_cols=A.shape[1],
            block_rows=block_rows,
            width_mult=width_mult,
        )

    # ----------------------------------------------------------------- views
    def block_view(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Block ``b`` as a ``(block_rows, widths[b])`` (nbr, wgt) rectangle."""
        lo, hi = int(self.row_ptr[b]), int(self.row_ptr[b + 1])
        shape = (self.block_rows, int(self.widths[b]))
        return (
            self.col_idx[lo:hi].reshape(shape),
            self.val[lo:hi].reshape(shape),
        )

    def width_buckets(self) -> List[WidthBucket]:
        """Group equal-width blocks into stacked rectangles.

        Buckets partition the true rows ``[0, num_rows)``: every row appears
        in exactly one bucket, padding rows of the last block are dropped.
        """
        by_width: Dict[int, List[int]] = {}
        for b, wd in enumerate(self.widths):
            by_width.setdefault(int(wd), []).append(b)
        out: List[WidthBucket] = []
        for wd in sorted(by_width):
            blocks = by_width[wd]
            rows_parts, nbr_parts, wgt_parts = [], [], []
            for b in blocks:
                r0 = b * self.block_rows
                r1 = min(r0 + self.block_rows, self.num_rows)
                if r1 <= r0:
                    continue
                nbr, wgt = self.block_view(b)
                rows_parts.append(np.arange(r0, r1, dtype=np.int32))
                nbr_parts.append(nbr[: r1 - r0])
                wgt_parts.append(wgt[: r1 - r0])
            if not rows_parts:
                continue
            out.append(
                WidthBucket(
                    width=wd,
                    rows=np.concatenate(rows_parts),
                    nbr=np.concatenate(nbr_parts, axis=0),
                    wgt=np.concatenate(wgt_parts, axis=0),
                )
            )
        return out

    def to_edges(
        self, include_pads: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flatten back to a destination-sorted COO triple.

        Slots are row-major, so ``dst`` is non-decreasing (an edge-sharded
        consumer sees contiguous destination runs).  Pad slots keep
        weight 0 and clamp their row id into range — no-ops under psum, but
        pure overhead for an edge-list consumer, so ``include_pads=False``
        drops them (order-preserving; on hub-skewed graphs this shrinks the
        result several-fold).
        """
        dst = np.empty(self.total_slots, dtype=np.int32)
        for b in range(self.num_blocks):
            lo, hi = int(self.row_ptr[b]), int(self.row_ptr[b + 1])
            r0 = b * self.block_rows
            rows = np.arange(r0, r0 + self.block_rows, dtype=np.int64)
            rows = np.minimum(rows, self.num_rows - 1)
            dst[lo:hi] = np.repeat(rows, int(self.widths[b])).astype(np.int32)
        if not include_pads:
            keep = self.val != 0.0
            return self.col_idx[keep], dst[keep], self.val[keep]
        return self.col_idx.copy(), dst, self.val.copy()

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.num_rows, self.num_cols), dtype=np.float64)
        src, dst, w = self.to_edges()
        np.add.at(A, (dst, src), w.astype(np.float64))
        return A


def blocked_csr_from_network(
    norm,
    *,
    alpha: float,
    hetero_scale: float,
    block_rows: int = 64,
    width_mult: int = 8,
) -> BlockedCSR:
    """Fused DHLP-2 operator ``A_eff = αβ·scale·H + α·M`` in blocked-CSR.

    ``norm`` is a :class:`~repro_torch.core.network.NormalizedNetwork`; the homo
    and hetero supports are disjoint so one blocked-CSR holds both.
    """
    coo = norm.to_coo()
    beta = 1.0 - alpha
    src = np.concatenate([coo.het_src, coo.hom_src])
    dst = np.concatenate([coo.het_dst, coo.hom_dst])
    w = np.concatenate(
        [alpha * beta * hetero_scale * coo.het_w, alpha * coo.hom_w]
    )
    return BlockedCSR.from_edges(
        src,
        dst,
        w,
        num_rows=norm.num_nodes,
        block_rows=block_rows,
        width_mult=width_mult,
    )


def split_blocked_csr_from_network(
    norm,
    *,
    hetero_scale: float,
    block_rows: int = 64,
    width_mult: int = 8,
) -> Tuple[BlockedCSR, BlockedCSR]:
    """(hetero, homo) blocked-CSR pair for DHLP-1's two-phase schedule.

    Weights are *unscaled* by α (the DHLP-1 loop applies α/β per phase);
    the hetero block does carry ``hetero_scale`` (a property of the
    operator, not of the schedule).
    """
    coo = norm.to_coo()
    het = BlockedCSR.from_edges(
        coo.het_src,
        coo.het_dst,
        hetero_scale * coo.het_w,
        num_rows=norm.num_nodes,
        block_rows=block_rows,
        width_mult=width_mult,
    )
    hom = BlockedCSR.from_edges(
        coo.hom_src,
        coo.hom_dst,
        coo.hom_w,
        num_rows=norm.num_nodes,
        block_rows=block_rows,
        width_mult=width_mult,
    )
    return het, hom


__all__ = [
    "BlockedCSR",
    "WidthBucket",
    "blocked_csr_from_network",
    "split_blocked_csr_from_network",
]
