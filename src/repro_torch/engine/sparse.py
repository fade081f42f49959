"""Sparse backends: blocked-CSR, the port's scalability path.

``sparse`` runs the *fused-superstep* plan: buckets are remapped into
permuted row order once at prepare time (neighbor ids rewritten through
the inverse permutation), so every round writes its output rows
contiguously — no per-round inverse-permute gather — and the round plus
the per-column convergence reduction ``max_r |Fn − F|`` come out of one
fused step.  Label state crosses the whole loop in permuted space and is
inverse-permuted exactly once on exit.  ``sparse`` lowers each round to
torch ops (gather + einsum); ``kernel`` is the same engine with each
bucket's fused round launched as the ``csr_round_residual`` CUDA kernel
(its plain version on the CPU).

Not ported yet (ROADMAP queue A.4): the legacy ``fused_superstep=False``
loops and DHLP-1 on these engines — both raise
:class:`~repro_torch.engine.base.BackendUnsupported` — and the GPU-keyed
autotune cache (the layout always resolves to
:data:`~repro_torch.engine.autotune.DEFAULT_PARAMS`).
``storage_dtype="bf16"`` stores operator weights and the per-round gather
panel in bfloat16 with f32 state and accumulation.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.blocked_csr import blocked_csr_from_network
from repro_torch.core.network import NormalizedNetwork
from repro_torch.core.solver import LPConfig, SolveResult, chunk_columns
from repro_torch.device import to_numpy_f64
from repro_torch.engine import autotune
from repro_torch.engine.base import (
    BackendUnsupported,
    LPEngine,
    Operator,
    register_backend,
)
from repro_torch.kernels.segment_reduce import (
    csr_aggregate_ref,
    csr_round_residual_op,
)

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}

# --------------------------------------------------------------------------
# Fused-superstep plan: permuted-space buckets with remapped neighbor ids
# --------------------------------------------------------------------------


#: exact-width re-bucketing policy: a bucket closes when the next row's
#: width drops below ``SLACK`` of the bucket max (once it has at least
#: ``MIN_ROWS`` rows); bucket widths round up to a multiple of 8.  On
#: heavy-tailed graphs this cuts padded nnz ~3x vs the block-rows layout
#: (which pads every row in a 64-row block to the block max).
_TIGHTEN_SLACK = 0.9
_TIGHTEN_MIN_ROWS = 16
_TIGHTEN_ALIGN = 8


def _tighten_buckets(buckets):
    """Re-bucket rows by exact nonzero width (row order is free here).

    The block-rows layout pads every row in a block to the block's max
    width — on power-law degree graphs that is ~2-3x wasted gather+FMA
    per round.  The permuted-space plan owns the row order outright, so
    it can sort all rows by true width and group near-equal widths,
    keeping padding to a few percent.  Zero-weight padding entries are
    dropped (exact: they contribute nothing to the aggregation).

    Returns ``[(rows, nbr, wgt), ...]`` numpy triples, widest first.
    """
    rows_all = np.concatenate([b.rows for b in buckets])
    nbr_all = [b.nbr[i] for b in buckets for i in range(b.nbr.shape[0])]
    wgt_all = [b.wgt[i] for b in buckets for i in range(b.wgt.shape[0])]
    widths = np.array([int((w != 0).sum()) for w in wgt_all])
    order = np.argsort(-widths, kind="stable")
    out = []
    i, n = 0, len(order)
    while i < n:
        wmax = max(int(widths[order[i]]), 1)
        j = i + 1
        while j < n and (
            widths[order[j]] >= _TIGHTEN_SLACK * wmax
            or j - i < _TIGHTEN_MIN_ROWS
        ):
            j += 1
        bw = -(-wmax // _TIGHTEN_ALIGN) * _TIGHTEN_ALIGN
        sel = order[i:j]
        nbr = np.zeros((len(sel), bw), dtype=np.int32)
        wgt = np.zeros((len(sel), bw), dtype=np.float32)
        for k, r in enumerate(sel):
            nz = np.flatnonzero(wgt_all[r])
            nbr[k, : nz.size] = nbr_all[r][nz]
            wgt[k, : nz.size] = wgt_all[r][nz]
        out.append((rows_all[sel], nbr, wgt))
        i = j
    return out


def _device_plan(bcsr, *, storage: str, device, weight_scale: float = 1.0):
    """Permuted-space bucket plan for the fused-superstep loop.

    Returns ``(buckets, perm, rank)``: ``perm`` is the bucket-concat row
    order (node id at each permuted position), ``rank = argsort(perm)``
    (permuted position of each node id).  Bucket neighbor ids are
    pre-remapped through ``rank`` so rounds gather from — and write to —
    permuted space directly: output rows land contiguously at static
    offsets, no per-round inverse permute.  Rows are re-bucketed by
    exact width (:func:`_tighten_buckets`).  Neighbor ids are checked
    here, once, on the host: the kernel gathers them unchecked.
    """
    tight = _tighten_buckets(bcsr.width_buckets())
    order = np.concatenate([rows for rows, _, _ in tight])
    rank = np.argsort(order).astype(np.int32)
    n = order.shape[0]
    wdt = _STORAGE[storage]
    dev = []
    for _, nbr, wgt in tight:
        if nbr.size and (nbr.min() < 0 or nbr.max() >= n):
            raise ValueError("blocked-CSR neighbor id out of range")
        dev.append(
            (
                torch.as_tensor(rank[nbr], device=device),
                torch.as_tensor(weight_scale * wgt).to(device=device, dtype=wdt),
            )
        )
    return (
        tuple(dev),
        torch.as_tensor(order.astype(np.int64), device=device),
        torch.as_tensor(rank.astype(np.int64), device=device),
    )


def _plan_round(buckets, F, base, *, c, use_kernel, storage):
    """One fused superstep over a permuted-space plan.

    ``F``/``base`` live in permuted space (f32); returns ``(Fn, delta)``
    with ``Fn`` permuted-space f32 and ``delta`` the per-column residual
    ``max_r |Fn − F|`` (exact: the row max is permutation-invariant).

    Two lowerings of the same math: the kernel path keeps the epilogue
    and residual partials in the kernel per bucket and writes each
    bucket's rows straight into ``Fn``; the torch-op path only fuses
    per-bucket gathers and runs the epilogue + residual as one pass over
    the whole state.
    """
    Fq = F.to(_STORAGE[storage]) if storage != "f32" else F
    if not use_kernel:
        parts = [csr_aggregate_ref(nbr, wgt, Fq) for nbr, wgt in buckets]
        Fn = c * base.float() + torch.cat(parts, dim=0)
        delta = (Fn - F.float()).abs().amax(dim=0)
        return Fn, delta
    Fn = torch.empty_like(F)
    dparts = []
    off = 0
    for nbr, wgt in buckets:
        m = nbr.shape[0]
        _, dl = csr_round_residual_op(
            nbr,
            wgt,
            Fq,
            base[off : off + m],
            F[off : off + m],
            c=c,
            out=Fn[off : off + m],
        )
        dparts.append(dl)
        off += m
    return Fn, torch.cat(dparts, dim=0).amax(dim=0)


def _dhlp2_plan_loop(
    buckets,
    perm,
    rank,
    Y,
    F0,
    *,
    beta2: float,
    sigma: float,
    max_iter: int,
    seed_mode: str,
    momentum: float,
    use_kernel: bool,
    storage: str,
):
    """Fused-superstep DHLP-2: state stays in permuted space end to end.

    A host loop; each round pays one ``bool(active.any())`` sync.
    """
    Yp = Y[perm]
    F = F_prev = F0[perm]
    s = Yp.shape[1]
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    col_iters = torch.zeros(s, dtype=torch.int32, device=Y.device)
    it = 0
    while it < max_iter and bool(active.any()):
        base = Yp if seed_mode == "fixed" else F
        Fn, delta = _plan_round(
            buckets, F, base, c=beta2, use_kernel=use_kernel, storage=storage
        )
        if momentum:
            # the kernel residual is pre-momentum; fold the heavy-ball
            # term in and recompute — still gather-free in permuted space
            Fn = Fn + momentum * (F - F_prev)
            delta = (Fn - F).abs().amax(dim=0)
        Fn = torch.where(active[None, :], Fn, F)
        col_iters += active.int()
        active = active & ~(delta < sigma)
        F_prev, F = F, Fn
        it += 1
    return F[rank], it, col_iters


class _CSRPayload:
    """Device-resident blocked-CSR operator bundle.

    ``plan`` is the fused-superstep permuted-space plan
    ``(buckets, perm, rank)``; ``layout`` the resolved
    ``(block_rows, width_mult)``.
    """

    def __init__(self, layout):
        self.layout = layout
        self.plan = None


_NOT_PORTED = "is not ported yet (ROADMAP queue A.4)"


@register_backend("sparse")
class SparseCSREngine(LPEngine):
    """Blocked-CSR width-bucket engine — the default scalability path."""

    supports_momentum = True
    use_kernel = False

    def __init__(
        self,
        config=None,
        *,
        device=None,
        block_rows=None,
        width_mult=None,
        fused_superstep=True,
    ):
        super().__init__(config if config is not None else LPConfig(), device=device)
        if not fused_superstep:
            raise BackendUnsupported(
                f"backend {self.name!r}: the legacy fused_superstep=False "
                f"loops {_NOT_PORTED}"
            )
        self.block_rows = block_rows  # None = default layout
        self.width_mult = width_mult

    def _resolve_params(self) -> autotune.TunedParams:
        """Layout: explicit kwargs > defaults (no GPU-keyed cache yet)."""
        base = autotune.DEFAULT_PARAMS
        return autotune.TunedParams(
            block_rows=self.block_rows or base.block_rows,
            width_mult=self.width_mult or base.width_mult,
        )

    def _build(self, norm: NormalizedNetwork) -> Operator:
        if self.config.alg != "dhlp2":
            raise BackendUnsupported(
                f"backend {self.name!r}: DHLP-1 on blocked-CSR {_NOT_PORTED}"
            )
        params = self._resolve_params()
        op = Operator(
            backend=self.name,
            norm=norm,
            num_nodes=norm.num_nodes,
            payload=_CSRPayload((params.block_rows, params.width_mult)),
        )
        self._fused_plan(op)
        return op

    def _fused_plan(self, op: Operator):
        """Permuted-space fused plan, built on first use."""
        pay: _CSRPayload = op.payload
        if pay.plan is None:
            cfg = self.config
            br, wm = pay.layout
            bcsr = blocked_csr_from_network(
                op.norm,
                alpha=cfg.alpha,
                hetero_scale=cfg.resolved_hetero_scale(op.norm.num_types),
                block_rows=br,
                width_mult=wm,
            )
            pay.plan = _device_plan(
                bcsr, storage=cfg.storage_dtype, device=self.device
            )
        return pay.plan

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(x), dtype=torch.float32, device=self.device
        )

    def solve(
        self,
        op: Operator,
        Y: np.ndarray,
        F0: Optional[np.ndarray] = None,
    ) -> SolveResult:
        cfg = self.config
        Y = np.asarray(Y)
        if Y.ndim == 1:
            Y = Y[:, None]
        chunks = chunk_columns(Y, cfg.seed_chunk)
        f0_chunks = (
            [None] * len(chunks)
            if F0 is None
            else chunk_columns(np.asarray(F0), cfg.seed_chunk)
        )
        buckets, perm, rank = self._fused_plan(op)
        beta = 1.0 - cfg.alpha
        parts: List[np.ndarray] = []
        outer, cols = 0, []
        for Yc, F0c in zip(chunks, f0_chunks):
            Yd = self._tensor(Yc)
            F0d = Yd if F0c is None else self._tensor(F0c)
            F, it, ci = _dhlp2_plan_loop(
                buckets,
                perm,
                rank,
                Yd,
                F0d,
                beta2=beta * beta,
                sigma=cfg.sigma,
                max_iter=cfg.max_iter,
                seed_mode=cfg.resolved_seed_mode(),
                momentum=cfg.momentum,
                use_kernel=self.use_kernel,
                storage=cfg.storage_dtype,
            )
            parts.append(to_numpy_f64(F))
            outer = max(outer, it)
            cols.append(ci.cpu().numpy())
        return SolveResult(
            F=parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1),
            outer_iters=outer,
            inner_iters=0,
            converged=bool(outer < cfg.max_iter),
            per_column_iters=np.concatenate(cols),
        )

    # -------------------------------------------------------------- rounds
    def round_with_residual(self, op: Operator, F, Y):
        """One fused superstep + its residual (serve's early-exit unit)."""
        beta2 = (1.0 - self.config.alpha) ** 2
        buckets, perm, rank = self._fused_plan(op)
        Fn, delta = _plan_round(
            buckets,
            self._tensor(F)[perm],
            self._tensor(Y)[perm],
            c=beta2,
            use_kernel=self.use_kernel,
            storage=self.config.storage_dtype,
        )
        return to_numpy_f64(Fn[rank]), to_numpy_f64(delta)

    def round(self, op: Operator, F, Y):
        return self.round_with_residual(op, F, Y)[0]


@register_backend("kernel")
class KernelCSREngine(SparseCSREngine):
    """Blocked-CSR with the fused ``csr_round_residual`` kernel per bucket.

    Only the fused DHLP-2 round has a kernel; DHLP-1's two-phase
    schedule stays on ``dense``.
    """

    supports_algs = ("dhlp2",)
    use_kernel = True
