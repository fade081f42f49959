"""Sparse backends: blocked-CSR, the port's scalability path.

``sparse`` runs the *fused-superstep* plan by default: buckets are
remapped into permuted row order once at prepare time (neighbor ids
rewritten through the inverse permutation), so every round writes its
output rows contiguously — no per-round inverse-permute gather — and the
round plus the per-column convergence reduction ``max_r |Fn − F|`` come
out of one fused step.  Label state crosses the whole loop in permuted
space and is inverse-permuted exactly once on exit.  ``sparse`` lowers
each round to torch ops (gather + einsum); ``kernel`` is the same engine
with each bucket's fused round launched as the ``csr_round_residual``
CUDA kernel (its plain version on the CPU).  The pre-fusion node-order
path (a round per bucket, inverse permute, then the residual) is kept
behind ``fused_superstep=False`` as the A/B baseline; on ``kernel`` its
rounds are the ``csr_round`` CUDA kernel.  DHLP-1 runs on ``sparse``
(both loops); ``kernel`` is DHLP-2 only, as in the reference.

The layout (``block_rows``, ``width_mult``) and the round kernels'
``slots_per_block`` resolve as explicit kwargs > the device-keyed
autotune cache (:mod:`repro_torch.engine.autotune`, consulted only with
``LPConfig.autotune``) > :data:`~repro_torch.engine.autotune.DEFAULT_PARAMS`.
``storage_dtype="bf16"`` stores the fused plans' operator weights and
the per-round gather panel in bfloat16 with f32 state and accumulation;
the legacy loops ignore it and run in f32, as the reference's do.

Every loop, fused and legacy, is a round handed to
:func:`~repro_torch.core.solver._converge` (DHLP-1's through
:func:`~repro_torch.core.solver._dhlp1_converge`), which owns the halt,
its sync and the ``lp.round`` / ``lp.halt`` ranges; ``solve`` hands its
seed chunks to :func:`~repro_torch.core.solver.solve_chunks`.

The legacy plan has two builders that share no logic, only the layout:
the engines build theirs once from a host network (``BlockedCSR``, then
``_device_buckets``); :func:`bucket_plan` builds the same buckets with
torch ops from a COO operator already on the device, on every
``dhlp-bio`` step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.blocked_csr import (
    blocked_csr_from_network,
    split_blocked_csr_from_network,
)
from repro_torch.core.network import NormalizedNetwork, seed_matrix
from repro_torch.core.solver import (
    LPConfig,
    SolveResult,
    _converge,
    _dhlp1_converge,
    solve_chunks,
)
from repro_torch.device import to_numpy_f64
from repro_torch.engine import autotune
from repro_torch.engine.base import LPEngine, Operator, register_backend
from repro_torch.kernels.segment_reduce import (
    LiveRows,
    csr_aggregate_ref,
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    live_rows,
)
from repro_torch.kernels.segment_reduce.ref import _aggregate_f32
from repro_torch.obs import profiler
from repro_torch.obs.profiler import hot_span

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


# --------------------------------------------------------------------------
# Legacy node-order path (fused_superstep=False): the A/B baseline
# --------------------------------------------------------------------------


def _device_buckets(bcsr, device):
    """Upload width buckets + the inverse row permutation (legacy path).

    Each bucket is ``(rows, nbr, wgt, live)`` with ``live`` its rows' live
    slot counts (:class:`~repro_torch.kernels.segment_reduce.LiveRows`).
    Always f32: the legacy loops ignore ``storage_dtype``.  Neighbor ids
    are checked here, once, on the host: the kernel gathers them unchecked.
    """
    buckets = bcsr.width_buckets()
    n = sum(b.rows.shape[0] for b in buckets)
    for b in buckets:
        if b.nbr.size and (b.nbr.min() < 0 or b.nbr.max() >= n):
            raise ValueError("blocked-CSR neighbor id out of range")
    dev = tuple(
        (
            torch.as_tensor(b.rows.astype(np.int64), device=device),
            torch.as_tensor(b.nbr, dtype=torch.int32, device=device),
            torch.as_tensor(b.wgt, dtype=torch.float32, device=device),
            live_rows(b.wgt, device),
        )
        for b in buckets
    )
    order = np.concatenate([b.rows for b in buckets])
    inv = np.argsort(order).astype(np.int64)
    return dev, torch.as_tensor(inv, device=device)


def bucket_plan(src, dst, w, num_rows: int, *, block_rows: int, width_mult: int):
    """The legacy width-bucket plan of a COO operator ``W[dst, src] = w``,
    built with torch ops where ``w`` lives: ``(buckets, inv_perm)`` as
    ``_device_buckets(BlockedCSR.from_edges(...))`` gives them, bit for
    bit, except that ``wgt`` is in ``w``'s dtype (each weight rounded
    through float32, as the host builder stores it).

    Zero-weight edges are dropped; the rest are laid out by a stable sort
    of ``dst``, each block of ``block_rows`` rows as wide as its longest
    row rounded up to ``width_mult``, the blocks in (width, id) order so
    that each bucket is one slice of the slot storage.  Every kept weight
    is nonzero, so a row's live length is its degree.  The edges stay on
    the device; the host waits twice (the kept count, then one copy of the
    block widths, the blocks' live slots and the id bounds) and uploads
    nothing.  Ids outside ``[0, num_rows)`` raise ``ValueError``: the
    kernel gathers unchecked.

    Its three parts run inside the ``bio.plan.download``, ``.bucket`` and
    ``.upload`` spans (``configs/dhlp_bio.py`` says what each covers); with
    a collector installed a build counts ``bio.plan.builds`` and
    ``bio.plan.slots`` (its padded slots).
    """
    n, br, wm = int(num_rows), int(block_rows), int(width_mult)
    if br < 1 or wm < 1:
        raise ValueError("block_rows and width_mult must be >= 1")
    dev = w.device
    nb = max(1, -(-n // br))
    with hot_span("bio.plan.download"):
        wf = w.float()
        kept = torch.nonzero(wf != 0).squeeze(1)  # the first wait: the kept count
        src_k, dst_k = src[kept], dst[kept]
        dst_s, order = torch.sort(dst_k, stable=True)
        starts = torch.searchsorted(dst_s, torch.arange(n + 1, dtype=dst_s.dtype, device=dev))
        deg = starts.diff()
        block_max = torch.zeros(nb * br, dtype=torch.int64, device=dev)
        block_max[:n] = deg
        block_max = block_max.view(nb, br).amax(dim=1)
        widths = ((block_max + wm - 1) // wm * wm).clamp_(min=wm)
        live = starts[(torch.arange(nb + 1, device=dev) * br).clamp_(max=n)].diff()
        if dst_s.numel():
            bounds = torch.stack([src_k.min(), src_k.max(), dst_s[0], dst_s[-1]]).long()
        else:
            bounds = torch.zeros(4, dtype=torch.int64, device=dev)
        host = torch.cat([widths, live, bounds]).cpu().numpy()  # the second wait
        widths_h, live_h, (s_lo, s_hi, d_lo, d_hi) = host[:nb], host[nb : 2 * nb], host[2 * nb :]
        if dst_s.numel() and (min(s_lo, d_lo) < 0 or max(s_hi, d_hi) >= n):
            raise ValueError("blocked-CSR neighbor id out of range")

    with hot_span("bio.plan.bucket"):
        rows_h = np.clip(n - np.arange(nb) * br, 0, br)
        slots_h = int((rows_h * widths_h).sum())
        # each block's first row and first slot in the (width, id) order
        rows_in = (n - torch.arange(nb, device=dev) * br).clamp_(0, br)
        first_row, first_slot = torch.empty_like(widths), torch.empty_like(widths)
        by_width_d = torch.sort(widths, stable=True).indices
        for first, size in ((first_row, rows_in), (first_slot, rows_in * widths)):
            ordered = size[by_width_d]
            first[by_width_d] = ordered.cumsum(0) - ordered
        d = dst_s.long()
        blk = d // br
        rank = torch.arange(d.shape[0], device=dev) - starts[d]
        slot = first_slot[blk] + (d - blk * br) * widths[blk] + rank
        nbr_all = torch.zeros(slots_h, dtype=torch.int32, device=dev)
        wgt_all = torch.zeros(slots_h, dtype=w.dtype, device=dev)
        nbr_all[slot] = src_k[order].int()
        wgt_all[slot] = wf[kept[order]].to(w.dtype)
        r = torch.arange(n, device=dev)
        inv_perm = first_row[r // br] + r % br
        rows_all = torch.empty_like(inv_perm)
        rows_all[inv_perm] = r
        lengths_all = torch.empty(n, dtype=torch.int32, device=dev)
        lengths_all[inv_perm] = deg.int()

    with hot_span("bio.plan.upload"):
        buckets = []
        row0 = slot0 = 0
        for wd in np.unique(widths_h):
            blocks = widths_h == wd
            m = int(rows_h[blocks].sum())
            if m == 0:
                continue
            wd = int(wd)
            buckets.append((
                rows_all[row0 : row0 + m],
                nbr_all[slot0 : slot0 + m * wd].view(m, wd),
                wgt_all[slot0 : slot0 + m * wd].view(m, wd),
                LiveRows(lengths_all[row0 : row0 + m], int(live_h[blocks].sum())),
            ))
            row0, slot0 = row0 + m, slot0 + m * wd
    tel = profiler._COLLECTOR
    if tel is not None:
        tel.count("bio.plan.builds")
        tel.count("bio.plan.slots", slots_h)
    return tuple(buckets), inv_perm


def _bucket_agg(buckets, inv_perm, F):
    """``A @ F`` via per-bucket gather + einsum, back in node order."""
    parts = [csr_aggregate_ref(nbr, wgt, F) for _, nbr, wgt, _ in buckets]
    return torch.cat(parts, dim=0)[inv_perm]


def _bucket_round(buckets, inv_perm, F, base, *, beta2: float, slots_per_block=None):
    """Fused round ``β²·base + A @ F`` per bucket through ``csr_round_op``.

    On CUDA tensors every bucket is one ``csr_round`` kernel launch (never
    the plain version); each writes its rows into a bucket-order buffer,
    which one gather puts back in node order.
    """
    out = torch.empty_like(F)
    off = 0
    for rows, nbr, wgt, live in buckets:
        m = nbr.shape[0]
        csr_round_op(
            nbr,
            wgt,
            F,
            base[rows],
            c=beta2,
            out=out[off : off + m],
            live=live,
            slots_per_block=slots_per_block,
        )
        off += m
    return out[inv_perm]


def _dhlp2_csr_loop(
    buckets,
    inv_perm,
    Y,
    F0,
    *,
    beta2: float,
    sigma: float,
    max_iter: int,
    seed_mode: str,
    momentum: float,
    use_kernel: bool,
    slots_per_block=None,
):
    """Pre-fusion DHLP-2 on blocked-CSR buckets (bench A/B baseline)."""

    def step(F, _):
        base = Y if seed_mode == "fixed" else F
        if use_kernel:
            Fn = _bucket_round(
                buckets, inv_perm, F, base, beta2=beta2, slots_per_block=slots_per_block
            )
        else:
            Fn = beta2 * base + _bucket_agg(buckets, inv_perm, F)
        return Fn, None

    return _converge(step, F0, sigma=sigma, max_iter=max_iter, momentum=momentum)


def _dhlp1_csr_loop(
    het_buckets,
    het_inv,
    hom_buckets,
    hom_inv,
    Y,
    F0,
    *,
    alpha: float,
    sigma: float,
    max_iter: int,
    max_inner: int,
    seed_mode: str,
):
    """Pre-fusion DHLP-1 on blocked-CSR (bench A/B baseline)."""
    beta = 1.0 - alpha
    return _dhlp1_converge(
        lambda F: beta * (Y if seed_mode == "fixed" else F)
        + alpha * _bucket_agg(het_buckets, het_inv, F),
        lambda Yp, Fi: (
            beta * Yp + alpha * _bucket_agg(hom_buckets, hom_inv, Fi),
            None,
        ),
        F0,
        sigma=sigma,
        max_iter=max_iter,
        max_inner=max_inner,
    )


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

    Returns ``(buckets, perm, rank)``: each bucket is ``(nbr, wgt, live)``
    with ``live`` its rows' live slot counts, taken from the f32 weights;
    ``perm`` is the bucket-concat row order (node id at each permuted
    position), ``rank = argsort(perm)`` (permuted position of each node
    id).  Bucket neighbor ids are
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
        scaled = weight_scale * wgt
        dev.append(
            (
                torch.as_tensor(rank[nbr], device=device),
                torch.as_tensor(scaled).to(device=device, dtype=wdt),
                live_rows(scaled, device),
            )
        )
    return (
        tuple(dev),
        torch.as_tensor(order.astype(np.int64), device=device),
        torch.as_tensor(rank.astype(np.int64), device=device),
    )


def _plan_round(buckets, F, base, *, c, use_kernel, storage, slots_per_block=None):
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
        parts = [_aggregate_f32(nbr, wgt, Fq) for nbr, wgt, _ in buckets]
        Fn = c * base.float() + torch.cat(parts, dim=0)
        delta = (Fn - F.float()).abs().amax(dim=0)
        return Fn, delta
    Fn = torch.empty_like(F)
    dparts = []
    off = 0
    for nbr, wgt, live in buckets:
        m = nbr.shape[0]
        _, dl = csr_round_residual_op(
            nbr,
            wgt,
            Fq,
            base[off : off + m],
            F[off : off + m],
            c=c,
            out=Fn[off : off + m],
            live=live,
            slots_per_block=slots_per_block,
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
    slots_per_block=None,
):
    """Fused-superstep DHLP-2: state stays in permuted space end to end.

    The round returns its residual; with momentum :func:`_converge`
    recomputes it, still gather-free in permuted space.
    """
    Yp = Y[perm]

    def step(F, _):
        base = Yp if seed_mode == "fixed" else F
        return _plan_round(
            buckets,
            F,
            base,
            c=beta2,
            use_kernel=use_kernel,
            storage=storage,
            slots_per_block=slots_per_block,
        )

    F, it, col_iters = _converge(
        step, F0[perm], sigma=sigma, max_iter=max_iter, momentum=momentum
    )
    return F[rank], it, col_iters


def _het_injection(het_buckets, het_base_map, reorder, F, src, *, beta, storage):
    """DHLP-1's outer hetero step ``β·src + α·H @ F`` in hom-permuted space.

    α is folded into the het weights.  The round takes the gather panel's
    dtype: with bf16 storage the result is bf16, and the inner loop starts
    from that rounded ``Yp`` — as in the reference, whose ``sparse`` engine
    reaches its oracle here.  So this is the plain version on any device.
    """
    Fq = F.to(_STORAGE[storage]) if storage != "f32" else F
    src_het = src[het_base_map]
    parts = []
    off = 0
    for nbr, wgt in het_buckets:
        m = nbr.shape[0]
        parts.append(csr_round_ref(nbr, wgt, Fq, src_het[off : off + m], beta))
        off += m
    return torch.cat(parts, dim=0)[reorder]


def _dhlp1_plan_loop(
    hom_buckets,
    het_buckets,
    het_base_map,
    reorder,
    hom_perm,
    hom_rank,
    Y,
    F0,
    *,
    alpha: float,
    sigma: float,
    max_iter: int,
    max_inner: int,
    seed_mode: str,
    storage: str,
):
    """Fused-superstep DHLP-1: state lives in *hom*-permuted space.

    The inner homogeneous solve dominates the superstep count, so its
    plan is fully gather-free; the outer hetero injection pays one base
    gather (``het_base_map``) and one output regather (``reorder``) per
    outer iteration.  α is folded into both plans' weights, so inner and
    outer rounds are plain fused rounds with ``c = β``.  Torch ops only:
    DHLP-1 has no kernel engine.
    """
    beta = 1.0 - alpha
    Y = Y[hom_perm]
    F, it, inner, col_iters = _dhlp1_converge(
        lambda F: _het_injection(
            het_buckets, het_base_map, reorder, F, Y if seed_mode == "fixed" else F,
            beta=beta, storage=storage,
        ),
        lambda Yp, Fi: _plan_round(
            hom_buckets, Fi, Yp, c=beta, use_kernel=False, storage=storage
        ),
        F0[hom_perm],
        sigma=sigma,
        max_iter=max_iter,
        max_inner=max_inner,
    )
    return F[hom_rank], it, inner, col_iters


class _CSRPayload:
    """Device-resident blocked-CSR operator bundle.

    ``plan``/``split_plan`` are the fused-superstep permuted-space plans
    (DHLP-2 / DHLP-1); ``fused``/``split`` the legacy node-order bundles
    (only built when ``fused_superstep=False``).  ``plan`` and ``fused``
    are also built lazily for DHLP-1 when ``round`` needs the fused
    DHLP-2 operator.  ``layout`` is the resolved ``(block_rows,
    width_mult)``, ``slots_per_block`` the round kernels' resolved block
    sizing.
    """

    def __init__(self, layout, slots_per_block):
        self.layout = layout
        self.slots_per_block = slots_per_block
        self.fused = None  # (buckets, inv_perm)
        self.split = None  # ((het_buckets, het_inv), (hom_buckets, hom_inv))
        self.plan = None  # (buckets, perm, rank)
        self.split_plan = None  # (hom_bk, het_bk, het_base_map, reorder,
        #                          hom_perm, hom_rank)


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
        slots_per_block=None,
        fused_superstep=True,
    ):
        super().__init__(config if config is not None else LPConfig(), device=device)
        self.block_rows = block_rows  # None = autotuned (or default)
        self.width_mult = width_mult
        self.slots_per_block = slots_per_block
        self.fused_superstep = fused_superstep

    def _resolve_params(self, norm: NormalizedNetwork) -> autotune.TunedParams:
        """Layout + block sizing: explicit kwargs > cache > defaults.

        The cache (keyed on this engine's device) is consulted only with
        ``config.autotune`` and when some parameter is left unset."""
        tuned = None
        if self.config.autotune and None in (
            self.block_rows,
            self.width_mult,
            self.slots_per_block,
        ):
            tuned = autotune.lookup(
                norm.num_nodes, autotune.network_nnz(norm), device=self.device
            )
        base = tuned if tuned is not None else autotune.DEFAULT_PARAMS
        return autotune.TunedParams(
            block_rows=self.block_rows or base.block_rows,
            width_mult=self.width_mult or base.width_mult,
            slots_per_block=self.slots_per_block or base.slots_per_block,
        )

    def _build(self, norm: NormalizedNetwork) -> Operator:
        cfg = self.config
        params = self._resolve_params(norm)
        pay = _CSRPayload(
            (params.block_rows, params.width_mult), params.slots_per_block
        )
        op = Operator(
            backend=self.name, norm=norm, num_nodes=norm.num_nodes, payload=pay
        )
        if cfg.alg == "dhlp2":
            if self.fused_superstep:
                self._fused_plan(op)
            else:
                self._fused_buckets(op)
            return op
        het, hom = split_blocked_csr_from_network(
            norm,
            hetero_scale=cfg.resolved_hetero_scale(norm.num_types),
            block_rows=params.block_rows,
            width_mult=params.width_mult,
        )
        if not self.fused_superstep:
            pay.split = (
                _device_buckets(het, self.device),
                _device_buckets(hom, self.device),
            )
            return op
        hom_bk, hom_perm, hom_rank = _device_plan(
            hom, storage=cfg.storage_dtype, device=self.device, weight_scale=cfg.alpha
        )
        het_buckets = het.width_buckets()
        het_order = np.concatenate([b.rows for b in het_buckets])
        het_rank = np.argsort(het_order)
        hom_rank_np = hom_rank.cpu().numpy()
        wdt = _STORAGE[cfg.storage_dtype]
        het_bk = tuple(
            (
                torch.as_tensor(hom_rank_np[b.nbr].astype(np.int32), device=self.device),
                # α·w in f32 on the host, then cast to the storage dtype
                torch.as_tensor(cfg.alpha * b.wgt).to(device=self.device, dtype=wdt),
            )
            for b in het_buckets
        )
        pay.split_plan = (
            hom_bk,
            het_bk,
            torch.as_tensor(hom_rank_np[het_order], device=self.device),
            torch.as_tensor(het_rank[hom_perm.cpu().numpy()], device=self.device),
            hom_perm,
            hom_rank,
        )
        return op

    def _fused_bcsr(self, op: Operator):
        cfg = self.config
        br, wm = op.payload.layout
        return blocked_csr_from_network(
            op.norm,
            alpha=cfg.alpha,
            hetero_scale=cfg.resolved_hetero_scale(op.norm.num_types),
            block_rows=br,
            width_mult=wm,
        )

    def _fused_buckets(self, op: Operator):
        """Legacy node-order fused buckets, built on first use."""
        pay: _CSRPayload = op.payload
        if pay.fused is None:
            pay.fused = _device_buckets(self._fused_bcsr(op), self.device)
        return pay.fused

    def _fused_plan(self, op: Operator):
        """Permuted-space fused plan, built on first use."""
        pay: _CSRPayload = op.payload
        if pay.plan is None:
            pay.plan = _device_plan(
                self._fused_bcsr(op),
                storage=self.config.storage_dtype,
                device=self.device,
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
        Y, F0 = seed_matrix(op.num_nodes, Y, F0)
        return solve_chunks(
            Y,
            F0,
            chunk=cfg.seed_chunk,
            max_iter=cfg.max_iter,
            upload=self._tensor,
            solve=lambda Yd, F0d: self._solve_chunk(op, Yd, F0d),
        )

    def _solve_chunk(self, op: Operator, Y, F0):
        """One seed chunk on the configured loop: ``(F, outer, inner, cols)``."""
        cfg = self.config
        pay: _CSRPayload = op.payload
        beta = 1.0 - cfg.alpha
        common = dict(
            sigma=cfg.sigma,
            max_iter=cfg.max_iter,
            seed_mode=cfg.resolved_seed_mode(),
        )
        if cfg.alg == "dhlp2":
            kw = dict(
                common, beta2=beta * beta, momentum=cfg.momentum,
                use_kernel=self.use_kernel, slots_per_block=pay.slots_per_block,
            )
            if self.fused_superstep:
                F, it, ci = _dhlp2_plan_loop(
                    *self._fused_plan(op), Y, F0, storage=cfg.storage_dtype, **kw
                )
            else:
                F, it, ci = _dhlp2_csr_loop(*self._fused_buckets(op), Y, F0, **kw)
            return F, it, 0, ci
        kw = dict(common, alpha=cfg.alpha, max_inner=cfg.max_inner)
        if self.fused_superstep:
            return _dhlp1_plan_loop(*pay.split_plan, Y, F0, storage=cfg.storage_dtype, **kw)
        (hb, hi), (mb, mi) = pay.split
        return _dhlp1_csr_loop(hb, hi, mb, mi, Y, F0, **kw)

    # -------------------------------------------------------------- rounds
    def round_with_residual(self, op: Operator, F, Y):
        """One fused superstep + its residual (serve's early-exit unit)."""
        beta2 = (1.0 - self.config.alpha) ** 2
        Fd, Yd = self._tensor(F), self._tensor(Y)
        if self.fused_superstep:
            buckets, perm, rank = self._fused_plan(op)
            Fn, delta = _plan_round(
                buckets,
                Fd[perm],
                Yd[perm],
                c=beta2,
                use_kernel=self.use_kernel,
                storage=self.config.storage_dtype,
                slots_per_block=op.payload.slots_per_block,
            )
            Fn = Fn[rank]
        else:
            buckets, inv = self._fused_buckets(op)
            if self.use_kernel:
                Fn = _bucket_round(
                    buckets, inv, Fd, Yd, beta2=beta2,
                    slots_per_block=op.payload.slots_per_block,
                )
            else:
                Fn = beta2 * Yd + _bucket_agg(buckets, inv, Fd)
            delta = (Fn - Fd).abs().amax(dim=0)
        return to_numpy_f64(Fn), to_numpy_f64(delta)

    def round(self, op: Operator, F, Y):
        return self.round_with_residual(op, F, Y)[0]


@register_backend("kernel")
class KernelCSREngine(SparseCSREngine):
    """Blocked-CSR with a CUDA kernel per bucket and round.

    The fused plan launches ``csr_round_residual``, the legacy
    ``fused_superstep=False`` loop ``csr_round``.  Only DHLP-2 has a
    kernel engine; DHLP-1's two-phase schedule stays on ``sparse`` and
    ``dense``.
    """

    supports_algs = ("dhlp2",)
    use_kernel = True
