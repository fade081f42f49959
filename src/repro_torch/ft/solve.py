"""Checkpointed solve: the host-driven round loop with durable state.

Giraph gives the paper's DHLP-1/2 superstep checkpointing for free —
Pregel snapshots vertex state at superstep barriers and a worker failure
rolls the computation back to the last barrier.  This module is that
barrier snapshot for our engines: the same host-driven ``engine.round``
loop as :mod:`repro_torch.obs.solve` (fused DHLP-2, fixed seeds, voteToHalt
freeze, optional heavy-ball momentum), but every ``interval`` supersteps
the full loop state — label panel ``F``, the momentum predecessor, the
per-column active mask and iteration counters — goes through
:class:`repro_torch.checkpoint.CheckpointManager` together with the
outer-iteration cursor.

A killed run resumes by restoring the latest durable superstep and
continuing the identical iteration: every array is saved bit-exact
(float64 host loop, lossless ``.npy``), so the resumed trajectory —
and therefore the final rankings — match an uninterrupted run with
``max|Δ| == 0``.  That needs a deterministic ``engine.round`` as well:
on a card the ``kernel`` engine builds the same plan in a fresh process
(bucket order, permutation, live lengths) and its round kernels use no
atomics, so the same inputs give the same bytes.

Eligibility matches :func:`repro_torch.obs.solve.supports_observed`; the
checkpointed loop always runs the whole seed panel in one block (a
chunked panel would need per-chunk cursors for no benefit — the fixed
point is chunk-independent).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.solver import SolveResult
from repro_torch.obs.solve import supports_observed

supports_checkpointed = supports_observed


class _NullTelemetry:
    """Telemetry shim for library use outside a Session."""

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def maybe_flush(self) -> None:
        pass

    def trace_span(self, kind: str, name: str):
        import contextlib

        return contextlib.nullcontext()


def _initial_state(Y: np.ndarray, F0: Optional[np.ndarray]) -> Dict[str, Any]:
    F = Y.copy() if F0 is None else np.array(F0, dtype=np.float64, copy=True)
    return {
        "F": F,
        "F_prev": F.copy(),
        "active": np.ones(Y.shape[1], dtype=bool),
        "col_iters": np.zeros(Y.shape[1], dtype=np.int32),
    }


def checkpointed_solve(
    engine,
    net,
    seeds: Optional[np.ndarray] = None,
    F0: Optional[np.ndarray] = None,
    *,
    manager,
    interval: int = 5,
    telemetry=None,
    injector=None,
    straggler=None,
) -> Tuple[SolveResult, Dict[str, Any]]:
    """``engine.run`` semantics with durable superstep barriers.

    Returns ``(result, ft_stats)`` where ``ft_stats`` carries the
    durability roll-up (checkpoints written, resume cursor, checkpoint
    root).  ``injector`` (a :class:`repro_torch.ft.FailureInjector`) fires at
    superstep boundaries on a *fresh* run only — a resumed run never
    re-fires, matching real crash semantics — so drills kill the process
    once and ``--resume`` completes cleanly.
    """
    from repro_torch.core.network import seed_matrix

    tel = telemetry if telemetry is not None else _NullTelemetry()
    op = engine.prepare(net)
    Y, F0 = seed_matrix(op.num_nodes, seeds, F0, dtype=np.float64)

    cfg = engine.config
    state = _initial_state(Y, F0)
    start_step, restored = manager.restore_latest(state)
    resumed_from: Optional[int] = None
    if restored is not None:
        state = restored
        resumed_from = start_step
        tel.count("ft.resumes")
    else:
        start_step = 0

    checkpoints = 0
    converged = False
    step = start_step
    residual = 0.0
    while step < cfg.max_iter:
        if injector is not None and resumed_from is None:
            injector.maybe_fail(step)
        t0 = time.perf_counter()
        with tel.trace_span("superstep", f"superstep:{step}"):
            F, F_prev, active = state["F"], state["F_prev"], state["active"]
            Fn = np.asarray(engine.round(op, F, Y), dtype=np.float64)
            if cfg.momentum:
                Fn = Fn + cfg.momentum * (F - F_prev)
            Fn = np.where(active[None, :], Fn, F)
            delta = np.max(np.abs(Fn - F), axis=0)
            state["col_iters"] = state["col_iters"] + active.astype(np.int32)
            still = active & ~(delta < cfg.sigma)
            residual = float(delta[active].max()) if active.any() else 0.0
        if straggler is not None:
            straggler.observe(time.perf_counter() - t0)
        state["F_prev"], state["F"], state["active"] = F, Fn, still
        step += 1
        tel.gauge("solve.residual", residual)
        tel.gauge("solve.active_columns", int(still.sum()))
        tel.maybe_flush()
        converged = not still.any()
        if converged or step % interval == 0:
            manager.save(
                step,
                state,
                metadata={"step": step, "residual": residual, "kind": "solve"},
            )
            checkpoints += 1
            tel.count("ft.checkpoints")
        if converged:
            break

    manager.wait()
    result = SolveResult(
        F=state["F"],
        outer_iters=step,
        inner_iters=0,
        converged=converged,
        per_column_iters=state["col_iters"],
    )
    tel.count("solve.supersteps", step - start_step)
    tel.count("solve.columns", Y.shape[1])
    stats: Dict[str, Any] = {
        "checkpoints": checkpoints,
        "resumed_from": resumed_from,
        "ckpt_dir": manager.root,
    }
    return result, stats
