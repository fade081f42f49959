"""Observed solve: a host-driven ``engine.round`` loop (DESIGN.md §14.3).

The engines run their whole iteration inside one loop of device work
that reports only the final state.  An observability-enabled
``Session.solve()`` drives the SAME fused update from the host instead,
one ``engine.round`` per superstep, recording the residual and
active-column series the Giraph aggregators report for free:

    base = Y                        (fixed-seed mode)
    Fn   = round(op, F, Y)          (= β²·base + A_eff @ F)
    Fn  += momentum · (F − F_prev)  (heavy-ball, when configured)
    Fn   = where(active, Fn, F)     (voteToHalt: converged columns freeze)

This replicates the fused DHLP-2 fixed-seed semantics exactly, so the
observed path lands on the same fixed point as ``engine.run``.  The loop
state is float64 on the host, as in the reference: every round hands
``F`` and ``Y`` to the engine (an upload each on a card) and takes ``Fn``
back, which is why the path is opt-in and never used by the serve tier.
Eligibility is checked by :func:`supports_observed`: fused DHLP-2, fixed
seeds, batched mode, and a backend implementing ``round`` — the Session
runs ``engine.run`` for anything else.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.solver import SolveResult


def supports_observed(engine) -> bool:
    """Whether ``engine`` can run the per-superstep observed loop."""
    from repro_torch.engine.base import LPEngine

    cfg = engine.config
    if cfg.alg != "dhlp2" or cfg.mode != "batched" or not cfg.fused:
        return False
    if cfg.resolved_seed_mode() != "fixed":
        return False
    # the loop steps with engine.round — a backend that never overrode
    # the (raising) base implementation cannot be observed
    return type(engine).round is not LPEngine.round


def _solve_block(
    engine, op, Y: np.ndarray, F0: Optional[np.ndarray], telemetry
) -> Tuple[np.ndarray, np.ndarray, bool, List[float], List[int]]:
    """One chunk of seed columns through the host round loop."""
    cfg = engine.config
    F = Y.copy() if F0 is None else np.array(F0, dtype=np.float64, copy=True)
    F_prev = F
    ncols = Y.shape[1]
    active = np.ones(ncols, dtype=bool)
    col_iters = np.zeros(ncols, dtype=np.int32)
    residuals: List[float] = []
    actives: List[int] = []
    converged = False
    for _ in range(cfg.max_iter):
        with telemetry.trace_span("superstep", f"superstep:{len(residuals)}"):
            Fn = np.asarray(engine.round(op, F, Y), dtype=np.float64)
            if cfg.momentum:
                Fn = Fn + cfg.momentum * (F - F_prev)
            Fn = np.where(active[None, :], Fn, F)
            delta = np.max(np.abs(Fn - F), axis=0)
            col_iters += active.astype(np.int32)
            still = active & ~(delta < cfg.sigma)
            residual = float(delta[active].max()) if active.any() else 0.0
        residuals.append(residual)
        actives.append(int(still.sum()))
        telemetry.maybe_flush()  # superstep boundary = solve-side streaming pump
        F_prev, F, active = F, Fn, still
        if not active.any():
            converged = True
            break
    return F, col_iters, converged, residuals, actives


def observed_solve(
    engine,
    net,
    seeds: Optional[np.ndarray] = None,
    F0: Optional[np.ndarray] = None,
    *,
    telemetry,
) -> SolveResult:
    """``engine.run`` semantics with per-superstep telemetry.

    Honors ``LPConfig.seed_chunk`` the way the jitted path does: chunks
    solve independently and their residual series merge per superstep
    (max residual, summed active columns) so the recorded convergence
    curve describes the whole solve, not the last chunk.
    """
    from repro_torch.core.network import seed_matrix

    op = engine.prepare(net)
    Y, F0 = seed_matrix(op.num_nodes, seeds, F0, dtype=np.float64)

    cfg = engine.config
    ncols = Y.shape[1]
    chunk = cfg.seed_chunk if 0 < cfg.seed_chunk < ncols else ncols
    blocks = []
    for c in range(0, ncols, chunk):
        blocks.append(
            _solve_block(
                engine,
                op,
                np.ascontiguousarray(Y[:, c : c + chunk]),
                None if F0 is None else np.ascontiguousarray(F0[:, c : c + chunk]),
                telemetry=telemetry,
            )
        )
    F = np.concatenate([b[0] for b in blocks], axis=1)
    col_iters = np.concatenate([b[1] for b in blocks])
    converged = all(b[2] for b in blocks)
    outer = max(len(b[3]) for b in blocks)

    # merged per-superstep series: the convergence curve `repro obs` plots
    for step in range(outer):
        residual = max(b[3][step] for b in blocks if step < len(b[3]))
        active = sum(b[4][step] for b in blocks if step < len(b[4]))
        telemetry.gauge("solve.residual", residual)
        telemetry.gauge("solve.active_columns", active)
    telemetry.count("solve.supersteps", outer)
    telemetry.count("solve.columns", ncols)

    return SolveResult(
        F=F,
        outer_iters=outer,
        inner_iters=0,
        converged=converged,
        per_column_iters=col_iters,
    )
