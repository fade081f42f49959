"""The online LP query engine (DESIGN.md §9).

Layers the dense/sparse batched solvers behind a query interface:

* ``query``/``submit`` — rank top-k candidates of a target type for one
  entity.  Repeat queries hit the column LRU; cold queries warm-start from
  the cached column of the most-similar same-type node when one exists.
* ``apply_delta`` — incremental graph update: bump the network version,
  demote affected cached columns to warm-start hints, and let subsequent
  queries re-converge from the stale state (delta propagation) instead of
  from scratch.

The batch tick is split into two stages so the scheduler can pipeline
them (DESIGN.md §9.1):

* :meth:`_assemble_batch` — queue-side, cheap: snapshot the network
  state, probe the (sharded) column cache, build the seed/warm-start
  matrices for the misses.  Runs WITHOUT the engine lock; the cache's
  per-shard locks are its only synchronization.
* :meth:`_execute_batch` — engine-side, the long pole: one batched solve
  for the misses, cache write-back, per-request ranking.  Serialized
  against ``apply_delta`` by the engine lock.

A delta landing between the two stages is benign: the solve runs against
the *assembled* snapshot (consistent answers, correct version stamp) and
the write-back demotes to a warm-start hint instead of publishing a
column under the wrong version.

Serving always runs the solver in **fixed-seed mode**: the fixed point
``F* = β²(I − A)⁻¹Y`` is then independent of the iteration's starting
state, which is exactly the property warm-starting relies on.

The LP engine runs on one device (``device=``; ``None`` = ``cuda:0``).
Every call into it happens under the engine lock, with that device made
current on the calling thread (the batcher's solver thread, or the
caller's for ``query``/``apply_delta``): one thread at a time launches,
and builds the engine's lazily assembled operator plan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.network import GraphDelta, HeteroNetwork
from repro_torch.core.ranking import topk_exclusive
from repro_torch.core.solver import LPConfig, SolveResult
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import make_engine, resolve_backend
from repro_torch.serve.cache import NetworkState, ShardedColumnCache
from repro_torch.serve.scheduler import MicroBatcher
from repro_torch.serve.types import QueryResult, QuerySpec


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine + scheduler + cache knobs."""

    lp: LPConfig = LPConfig(alg="dhlp2", seed_mode="fixed")
    # any `repro_torch.engine` registry backend incl. "auto".  "sharded" serves
    # on the host's full device set (auto never selects it — running a
    # pod-backed deployment is an explicit choice); its solve AND round
    # paths both run sharded, so incremental hint refresh stays on-mesh.
    # None defers to lp.backend, then "dense"; setting BOTH this and
    # lp.backend to different keys is a conflict, not a silent precedence.
    engine: Optional[str] = None
    cache_columns: int = 4096        # column-LRU capacity
    cache_shards: int = 1            # independently-locked cache shards
    warm_start: bool = True          # neighbor/stale warm starts
    carry_untouched: bool = True     # keep untouched-type columns on delta
    # after a delta, advance demoted stale hints this many fused LP rounds
    # against the NEW operator (engine.round) so the next query's warm
    # start is already partway to the moved fixed point (dhlp2 only — the
    # round contract is the fused DHLP-2 update)
    refresh_rounds: int = 0
    max_batch: int = 64
    max_wait_s: float = 0.005
    queue_depth: int = 1024
    # batches in flight between assembly start and future resolution; 1 =
    # the synchronous tick, 2 = double-buffered (assemble next while the
    # engine solves current)
    pipeline_depth: int = 1
    # convergence-aware batch solves: per-column residual checks drop
    # converged columns from subsequent rounds (the BSP no-activity halt,
    # per column).  dhlp2 + no momentum only — the loop is built on the
    # engine.round contract.
    early_exit: bool = False

    def resolved_engine(self) -> str:
        """Backend key serving will use (before any ``auto`` resolution)."""
        return self.engine or self.lp.backend or "dense"

    def __post_init__(self):
        if (
            self.engine is not None
            and self.lp.backend is not None
            and self.engine != self.lp.backend
        ):
            raise ValueError(
                f"ServeConfig.engine={self.engine!r} conflicts with "
                f"LPConfig.backend={self.lp.backend!r}; set one (or both "
                "to the same key)"
            )
        resolved = self.resolved_engine()
        if resolved != "auto":
            from repro_torch.engine import UnknownBackendError, get_backend_class

            try:
                resolve_backend(resolved)
            except UnknownBackendError as e:
                raise ValueError(f"unknown engine {resolved!r}: {e}") from e
            cls = get_backend_class(resolved)
            if self.lp.alg not in cls.supports_algs:
                # fail at construction, not at the first query batch —
                # a bad config inside a coalesced batch fails every
                # co-batched request
                raise ValueError(
                    f"engine {resolved!r} does not support alg "
                    f"{self.lp.alg!r} (supports {cls.supports_algs})"
                )
            if self.lp.momentum and not cls.supports_momentum:
                raise ValueError(
                    f"engine {resolved!r} has no momentum loop "
                    f"(LPConfig.momentum={self.lp.momentum})"
                )
        if self.refresh_rounds < 0:
            raise ValueError("refresh_rounds must be >= 0")
        if self.refresh_rounds and self.lp.alg != "dhlp2":
            # engine.round is the fused DHLP-2 update; advancing DHLP-1
            # hints with it would walk them toward the WRONG fixed point.
            raise ValueError(
                "refresh_rounds requires alg='dhlp2' (the round contract "
                "is the fused DHLP-2 update)"
            )
        if self.lp.resolved_seed_mode() != "fixed":
            # Warm starts and incremental re-solves need the F0-independent
            # fixed point; drift mode's answer depends on the start state.
            raise ValueError(
                "serving requires fixed-seed mode "
                "(LPConfig(seed_mode='fixed'))"
            )
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.cache_shards < 1:
            raise ValueError("cache_shards must be >= 1")
        if self.cache_shards > self.cache_columns:
            raise ValueError(
                f"cache_shards={self.cache_shards} > "
                f"cache_columns={self.cache_columns}: every shard needs "
                "at least one slot"
            )
        if self.early_exit and self.lp.alg != "dhlp2":
            raise ValueError(
                "early_exit requires alg='dhlp2' (the per-column residual "
                "loop is built on the fused DHLP-2 engine.round contract)"
            )
        if self.early_exit and self.lp.momentum:
            raise ValueError(
                "early_exit and momentum are mutually exclusive — the "
                "early-exit round loop is the plain heavy-ball-free update"
            )


@dataclasses.dataclass
class _FTKit:
    """Serve-side durability state attached by :meth:`LPServeEngine.enable_ft`.

    ``attempts`` counts every entry into the guarded execute stage (so the
    injector's step key is unique per *attempt* and a retried batch gets a
    fresh key — a fault fires once, not on every replay); ``completed``
    counts successful batches and drives the checkpoint cadence.
    """

    guard: Optional[Any] = None
    straggler: Optional[Any] = None
    injector: Optional[Any] = None
    manager: Optional[Any] = None
    interval: int = 5
    attempts: int = 0
    completed: int = 0
    checkpoints: int = 0
    watermark: int = -1      # network version of the last durable snapshot
    ckpt_dir: Optional[str] = None
    closed: bool = False


@dataclasses.dataclass
class PreparedBatch:
    """Everything stage 2 needs, snapshotted by stage 1.

    ``state`` pins the network version the batch was assembled against;
    the solve and the ranking both use it, so a mid-flight delta cannot
    split one batch across two versions.
    """

    state: NetworkState
    specs: List[QuerySpec]
    cols: Dict[int, Optional[np.ndarray]]   # entity -> column (None = miss)
    sources: Dict[int, str]
    rounds: Dict[int, int]
    miss_nodes: List[int]
    Y: Optional[np.ndarray]                 # (N, misses) seed columns
    F0: Optional[np.ndarray]                # warm/seed starting state
    warm: List[bool]                        # per miss: warm-started?


class LPServeEngine:
    """Query front-end over a (mutable, versioned) heterogeneous network."""

    def __init__(
        self,
        net: HeteroNetwork,
        config: ServeConfig = ServeConfig(),
        *,
        engine=None,
        norm=None,
        telemetry=None,
        device: DeviceLike = None,
    ):
        """``engine``/``norm`` let a :class:`repro_torch.api.session.Session`
        inject its already-prepared LP engine and normalized view, so the
        serve path reuses the operator assembled for the solve stage
        instead of re-preparing per entry point (DESIGN.md §13).
        ``telemetry`` threads one :class:`repro_torch.obs.Telemetry` into the
        batcher and column cache (DESIGN.md §14).  ``device`` is where a
        new engine runs; an injected engine keeps its own, and a
        ``device`` that names another one is an error."""
        self.config = config
        self._state = NetworkState.from_network(net, version=0, norm=norm)
        backend = resolve_backend(
            config.resolved_engine(), num_nodes=net.num_nodes,
            config=config.lp,
        )
        if engine is not None:
            if engine.name != backend:
                raise ValueError(
                    f"injected engine backend {engine.name!r} conflicts "
                    f"with ServeConfig's resolved engine {backend!r}"
                )
            if engine.config != config.lp:
                raise ValueError(
                    "injected engine's LPConfig differs from "
                    "ServeConfig.lp — serving would answer from different "
                    "math than the engine was prepared with"
                )
            if device is not None and resolve_device(device) != engine.device:
                raise ValueError(
                    f"injected engine runs on {engine.device}, which "
                    f"conflicts with device={device!r}"
                )
            self._engine = engine
        else:
            self._engine = make_engine(backend, config.lp, device=device)
        self.columns = ShardedColumnCache(
            config.cache_columns,
            shards=config.cache_shards,
            telemetry=telemetry,
        )
        self.batcher = MicroBatcher(
            self._solve_batch,
            max_batch=config.max_batch,
            max_wait_s=config.max_wait_s,
            queue_depth=config.queue_depth,
            pipeline_depth=config.pipeline_depth,
            assemble=self._assemble_batch,
            execute=self._execute_batch,
            telemetry=telemetry,
        )
        self._tel = telemetry
        # early-exit residual-threshold multiplier: the SLO watchdog's
        # second degradation rung widens it (columns leave the active set
        # sooner -> cheaper solves, coarser tails) and restores it to 1.0
        # on recovery
        self._sigma_scale = 1.0
        # one solve/update at a time: the engines' prepared-operator caches
        # are single-entry and not concurrency-safe; the sharded column
        # cache carries its own locks, so assembly stays outside this lock
        self._lock = threading.Lock()
        self._ft: Optional[_FTKit] = None

    # ------------------------------------------------------------ accessors
    @property
    def state(self) -> NetworkState:
        return self._state

    @property
    def version(self) -> int:
        return self._state.version

    @property
    def sigma_scale(self) -> float:
        return self._sigma_scale

    def set_sigma_scale(self, scale: float) -> None:
        """Runtime early-exit degradation knob (>= 1.0 widens σ).

        Only the early-exit solve path honors it; on a full-superstep
        engine the knob is recorded but inert.
        """
        if scale < 1.0:
            raise ValueError(f"sigma_scale must be >= 1.0, got {scale}")
        self._sigma_scale = float(scale)
        if self._tel is not None:
            self._tel.gauge("serve.early_exit.sigma_scale", self._sigma_scale)

    # -------------------------------------------------------------- queries
    def _validate(self, spec: QuerySpec, state: NetworkState) -> None:
        """Reject bad specs at the edge, before they join a batch.

        A bad spec inside a coalesced batch would fail every co-batched
        request; validity is stable once checked — the node-id space only
        ever grows (``GraphDelta.add_nodes``) and the type count is fixed.
        """
        if not 0 <= spec.entity < state.num_nodes:
            raise ValueError(
                f"entity {spec.entity} out of range [0,{state.num_nodes})"
            )
        if not 0 <= spec.target_type < state.net.num_types:
            raise ValueError(f"no such type {spec.target_type}")

    def submit(self, spec: QuerySpec, **kw) -> "Future[QueryResult]":
        """Enqueue for the micro-batcher (needs ``start()`` or ``drain()``)."""
        self._validate(spec, self._state)
        return self.batcher.submit(spec, **kw)

    def query(self, spec: QuerySpec) -> QueryResult:
        """Synchronous single query (a batch of one on a cache miss)."""
        return self._solve_batch([spec])[0]

    def start(self) -> None:
        self.batcher.start()

    def stop(self) -> None:
        self.batcher.stop()

    # ------------------------------------------------------ stage 1: assemble
    def _assemble_batch(self, specs: Sequence[QuerySpec]) -> PreparedBatch:
        """Cache probe + seed/warm-start assembly (no engine lock)."""
        state = self._state  # one atomic snapshot for the whole batch
        n = state.num_nodes
        for spec in specs:
            self._validate(spec, state)  # no-op for specs vetted at submit()

        # split hits from misses; dedupe miss columns within the batch
        cols: Dict[int, Optional[np.ndarray]] = {}
        sources: Dict[int, str] = {}
        rounds: Dict[int, int] = {}
        miss_nodes: List[int] = []
        for spec in specs:
            node = spec.entity
            if node in cols:
                continue
            cached = self.columns.get(state.version, node)
            if cached is not None:
                cols[node] = cached
                sources[node] = "cache"
                rounds[node] = 0
            else:
                cols[node] = None  # placeholder, solved in stage 2
                miss_nodes.append(node)

        Y = F0 = None
        warm: List[bool] = []
        if miss_nodes:
            warm_index = (
                self._cached_by_type(state) if self.config.warm_start else {}
            )
            Y = np.zeros((n, len(miss_nodes)), dtype=np.float64)
            F0 = np.zeros_like(Y)
            for c, node in enumerate(miss_nodes):
                Y[node, c] = 1.0
                hint = (
                    self._warm_hint(node, warm_index, state)
                    if self.config.warm_start
                    else None
                )
                if hint is not None:
                    F0[:, c] = hint
                    warm.append(True)
                else:
                    F0[:, c] = Y[:, c]
                    warm.append(False)
        return PreparedBatch(
            state=state, specs=list(specs), cols=cols, sources=sources,
            rounds=rounds, miss_nodes=miss_nodes, Y=Y, F0=F0, warm=warm,
        )

    # ------------------------------------------------------- stage 2: execute
    def _execute_batch(self, prepared: PreparedBatch) -> List[QueryResult]:
        """Stage-2 entry point; adds the FT envelope when enabled.

        The fault injector keys on the *attempt* index (unique per entry,
        including guarded replays of the same :class:`PreparedBatch`), the
        straggler watch times the whole execute, and every ``interval``
        completed batches the current version's cache columns go through
        the checkpoint manager.  With FT disabled this is a direct call.
        """
        ft = self._ft
        if ft is None:
            return self._execute_batch_impl(prepared)
        idx = ft.attempts
        ft.attempts += 1
        if ft.injector is not None:
            ft.injector.maybe_fail(idx)
        t0 = time.perf_counter()
        out = self._execute_batch_impl(prepared)
        if ft.straggler is not None:
            ft.straggler.observe(time.perf_counter() - t0)
        ft.completed += 1
        if (
            ft.manager is not None
            and not ft.closed
            and ft.completed % ft.interval == 0
        ):
            self._ft_checkpoint()
        return out

    def _execute_batch_impl(self, prepared: PreparedBatch) -> List[QueryResult]:
        """Batched solve + cache write-back + ranking (engine lock held)."""
        with self._lock:
            state = prepared.state
            cols, sources, rounds = (
                prepared.cols, prepared.sources, prepared.rounds,
            )
            if prepared.miss_nodes:
                result = self._run_solver(state, prepared.Y, prepared.F0)
                per_col = (
                    result.per_column_iters
                    if result.per_column_iters is not None
                    else np.full(
                        len(prepared.miss_nodes), result.outer_iters, np.int32
                    )
                )
                # a delta may have landed after assembly: publishing under
                # state.version would be a dead key, so demote to a
                # warm-start hint instead (same treatment the delta gives
                # live columns)
                stale = self._state.version != state.version
                for c, node in enumerate(prepared.miss_nodes):
                    col = result.F[:, c]
                    cols[node] = col
                    sources[node] = "warm" if prepared.warm[c] else "cold"
                    rounds[node] = int(per_col[c])
                    if stale:
                        self.columns.put_stale(node, col)
                    else:
                        self.columns.put(state.version, node, col)
            return [
                self._rank(spec, cols[spec.entity], sources[spec.entity],
                           rounds[spec.entity], state)
                for spec in prepared.specs
            ]

    # ------------------------------------------------------------- the tick
    def _solve_batch(self, specs: Sequence[QuerySpec]) -> List[QueryResult]:
        """One-stage tick: the synchronous drivers' (and tests') path."""
        return self._execute_batch(self._assemble_batch(specs))

    # ------------------------------------------------------- fault tolerance
    def enable_ft(
        self,
        *,
        guard=None,
        straggler=None,
        injector=None,
        manager=None,
        interval: int = 5,
    ) -> None:
        """Attach the durability kit (DESIGN.md §16).

        ``guard`` (a :class:`repro_torch.ft.StepGuard`) is installed on the
        batcher so solver-thread batch execution retries transient
        failures; its ``restore_fn`` is pointed at :meth:`_ft_restore`, so
        retry exhaustion rolls the column cache back to the last durable
        snapshot and the in-flight batch replays against restored state.
        ``manager`` (a :class:`repro_torch.checkpoint.CheckpointManager`) takes
        an immediate snapshot — the restore watermark exists before the
        first fault can.
        """
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self._ft = _FTKit(
            guard=guard,
            straggler=straggler,
            injector=injector,
            manager=manager,
            interval=interval,
            ckpt_dir=getattr(manager, "root", None),
        )
        if guard is not None:
            guard.restore_fn = self._ft_restore
            self.batcher.guard = guard
        if manager is not None:
            self._ft_checkpoint()

    def _ft_checkpoint(self) -> None:
        """Snapshot the current version's cached columns durably.

        Stats-neutral read (``cache.snapshot``), saved as two leaves —
        node ids and the stacked float64 column panel — plus the network
        version in metadata: the restore's invalidation watermark.
        """
        ft = self._ft
        version = self._state.version
        snap = self.columns.snapshot(version)
        nodes = np.array([n for n, _ in snap], dtype=np.int64)
        cols = (
            np.stack([c for _, c in snap], axis=1).astype(np.float64)
            if snap
            else np.zeros((self._state.num_nodes, 0), dtype=np.float64)
        )
        ft.manager.save(
            ft.checkpoints,
            [nodes, cols],
            metadata={"version": version, "kind": "serve-cache",
                      "completed": ft.completed},
        )
        ft.checkpoints += 1
        ft.watermark = version
        if self._tel is not None:
            self._tel.count("ft.checkpoints")

    def _ft_restore(self) -> None:
        """Roll the column cache back to the last durable snapshot.

        Columns published after the snapshot's version watermark are
        dropped outright (they may carry state from the failed execution);
        snapshot columns re-enter as servable entries when the version
        still matches, else as warm-start hints.  The replayed batch then
        re-solves its misses against clean state.
        """
        ft = self._ft
        with self._lock:
            if ft is None or ft.manager is None:
                # no durable snapshot to return to: drop every cached
                # column — replays re-solve from seeds, which is safe
                self.columns.invalidate_newer(-1)
                return
            step, leaves, meta = ft.manager.restore_latest_flat()
            watermark = int(meta.get("version", -1)) if step is not None else -1
            self.columns.invalidate_newer(watermark)
            if step is None or not leaves:
                return
            nodes, cols = leaves[0], leaves[1]
            n = self._state.num_nodes
            fresh = watermark == self._state.version
            for i, node in enumerate(np.asarray(nodes, dtype=np.int64)):
                col = np.asarray(cols[:, i], dtype=np.float64)
                if fresh and col.shape[0] == n:
                    self.columns.put(watermark, int(node), col)
                elif col.shape[0] == n:
                    self.columns.put_stale(int(node), col)

    def ft_stats(self) -> Dict[str, Any]:
        """Durability roll-up for the serve artifact (empty when FT off)."""
        ft = self._ft
        if ft is None:
            return {}
        out: Dict[str, Any] = {
            "batches": ft.completed,
            "checkpoints": ft.checkpoints,
            "watermark": ft.watermark,
        }
        if ft.guard is not None:
            out["retries"] = ft.guard.retries
            out["restores"] = ft.guard.restores
        if ft.straggler is not None:
            out["straggler_flags"] = ft.straggler.slow_steps
        if ft.injector is not None:
            out["injected_faults"] = list(ft.injector.fired)
        if ft.ckpt_dir is not None:
            out["ckpt_dir"] = ft.ckpt_dir
        return out

    def close_ft(self) -> None:
        """Final snapshot + writer-thread shutdown (idempotent).

        Keeps ``ft_stats()`` readable after close — the Session reads the
        roll-up into the serve artifact after draining the trace.
        """
        ft = self._ft
        if ft is None or ft.closed:
            return
        if ft.manager is not None:
            self._ft_checkpoint()
            ft.manager.close()
        ft.closed = True

    def _run_solver(
        self, state: NetworkState, Y: np.ndarray, F0: np.ndarray
    ) -> SolveResult:
        # every registered engine caches its prepared operator on the
        # normalized network's identity, so repeat batches skip re-assembly
        with _current_device(self._engine.device):
            if self.config.early_exit:
                return self._solve_early_exit(state, Y, F0)
            return self._engine.run(state.norm, seeds=Y, F0=F0)

    def _solve_early_exit(
        self, state: NetworkState, Y: np.ndarray, F0: np.ndarray
    ) -> SolveResult:
        """Batched solve with per-column convergence early exit.

        The BSP no-activity halt, per column: after each fused round the
        per-column residual ``max|F_{t+1} − F_t|`` is checked against σ
        and converged columns leave the active set — subsequent rounds
        run a strictly narrower matmul.  Fixed-seed mode makes this exact
        (each column's fixed point is independent of its co-batch), so
        the result matches the full-superstep solve to iteration
        tolerance; dtype is float64 end to end via ``engine.round``.

        The active width is padded up to the next power of two with zero
        columns (a zero seed + zero state is a fixed point, so the pad
        is inert), as the reference does for its compiled rounds: the
        round then sees at most ``log2(max_batch) + 1`` column widths, so
        the ``kernel`` engine's ``csr_round_residual`` launches come in
        that many shapes.  Each round hands ``Fa``/``Ya`` to the engine
        and takes ``Fn``/``delta`` back as host arrays (the reference's
        interface; a copy each way per round on a card).
        """
        cfg = self.config.lp
        op = self._engine.prepare(state.norm)
        n = F0.shape[0]
        F = np.array(F0, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        k = F.shape[1]
        col_iters = np.zeros(k, dtype=np.int32)
        active = np.arange(k)
        it = 0
        while active.size and it < cfg.max_iter:
            a = int(active.size)
            width = 1 << (a - 1).bit_length()  # next power of two
            Fa = np.zeros((n, width), dtype=np.float64)
            Ya = np.zeros((n, width), dtype=np.float64)
            Fa[:, :a] = F[:, active]
            Ya[:, :a] = Y[:, active]
            # fused superstep: the engine emits the per-column residual
            # from the same launch as the round (no host-side reduction)
            Fn, delta = self._engine.round_with_residual(op, Fa, Ya)
            Fn = np.asarray(Fn, dtype=np.float64)[:, :a]
            delta = np.asarray(delta, dtype=np.float64)[:a]
            F[:, active] = Fn
            col_iters[active] += 1
            active = active[delta >= cfg.sigma * self._sigma_scale]
            it += 1
        return SolveResult(
            F=F,
            outer_iters=int(col_iters.max(initial=0)),
            inner_iters=0,
            converged=(active.size == 0),
            per_column_iters=col_iters,
        )

    def _cached_by_type(self, state: NetworkState) -> Dict[int, List[int]]:
        """Group the current version's cached nodes by type, once per tick."""
        by_type: Dict[int, List[int]] = {}
        for other in self.columns.cached_nodes(state.version):
            by_type.setdefault(int(state.type_of[other]), []).append(other)
        return by_type

    def _warm_hint(
        self,
        node: int,
        by_type: Dict[int, List[int]],
        state: NetworkState,
    ) -> Optional[np.ndarray]:
        """Warm-start column for a cold node.

        Preference order: the node's own stale column from before the last
        delta (delta propagation), else the fresh column of the
        most-similar cached node of the same type (neighbor warm start —
        one vectorized similarity-row lookup, not a per-node scan).
        """
        stale = self.columns.stale_hint(node)
        if stale is not None and stale.shape[0] == state.num_nodes:
            return stale
        t, u = state.local_id(node)
        cands = [o for o in by_type.get(t, ()) if o != node]
        if not cands:
            return None
        sims = state.net.P[t][u, np.asarray(cands) - state.offsets[t]]
        best = int(np.argmax(sims))
        if sims[best] <= 0.0:
            return None
        return self.columns.get(state.version, cands[best])

    # -------------------------------------------------------------- ranking
    def _rank(
        self,
        spec: QuerySpec,
        col: np.ndarray,
        source: str,
        rounds: int,
        state: NetworkState,
    ) -> QueryResult:
        t_ent, u = state.local_id(spec.entity)
        tt = spec.target_type
        off = state.offsets[tt]
        scores = np.asarray(col[off : off + state.sizes[tt]], dtype=np.float64)
        exclude = np.zeros(scores.shape[0], dtype=bool)
        if not spec.include_known:
            R = state.net.R
            if (t_ent, tt) in R:
                exclude |= R[(t_ent, tt)][u] > 0
            elif (tt, t_ent) in R:
                exclude |= R[(tt, t_ent)][:, u] > 0
        if t_ent == tt:
            exclude[u] = True  # an entity is not its own candidate
        cand = topk_exclusive(scores, spec.top_k, exclude)
        return QueryResult(
            spec=spec,
            candidates=cand,
            scores=scores[cand],
            target_offset=off,
            version=state.version,
            source=source,
            rounds=rounds,
        )

    # ------------------------------------------------------ incremental path
    def apply_delta(self, delta: GraphDelta) -> int:
        """Apply a graph edit; returns the new network version.

        Cached columns whose types the delta touches are demoted to
        warm-start hints; untouched-type columns are carried forward when
        ``carry_untouched`` (approximation: their values shift by at most
        the delta's propagated mass — see DESIGN.md §9.3).  When the delta
        adds nodes every column demotes (the id space changed shape) and
        stale hints are remapped into the new layout.
        """
        with self._lock:
            if delta.is_empty:
                return self._state.version
            old = self._state
            new_net = old.net.apply_delta(delta)
            new = NetworkState.from_network(new_net, old.version + 1)
            remap = None
            if delta.add_nodes:
                remap = _make_remap(old, new)
            self.columns.invalidate_for_delta(
                old.version,
                new.version,
                delta.touched_types(),
                old.type_of,
                remap=remap,
                carry_untouched=self.config.carry_untouched,
            )
            self._state = new
            self._maybe_rescale_engine()
            if self.config.refresh_rounds:
                self._refresh_stale_hints()
            return new.version

    def _maybe_rescale_engine(self) -> None:
        """Re-resolve an ``auto`` engine after the network changed size.

        Node-adding deltas can push the network across the dense/sparse
        policy boundary (§11); an ``auto`` deployment must not keep
        rebuilding an O(N²) dense operator forever.  Explicitly pinned
        engines are left alone.  Called under ``self._lock``.
        """
        if self.config.resolved_engine() != "auto":
            return
        backend = resolve_backend(
            "auto", num_nodes=self._state.num_nodes, config=self.config.lp
        )
        if backend != self._engine.name:
            self._engine = make_engine(
                backend, self.config.lp, device=self._engine.device
            )

    def _refresh_stale_hints(self) -> int:
        """Advance demoted hints toward the new fixed point (§9.3).

        One batched ``engine.round`` per refresh round: the fused update
        ``β²Y + A_eff @ F`` is a contraction toward the NEW operator's
        fixed point, so k rounds leave every hint k rounds closer — the
        next query's warm start re-converges in fewer rounds without
        paying a full solve at delta time.  Called under ``self._lock``.
        """
        state = self._state
        n = state.num_nodes
        hints = {
            v: h
            for v in self.columns.stale_nodes()
            if (h := self.columns.stale_hint(v)) is not None
            and h.shape[0] == n
        }
        if not hints:
            return 0
        with _current_device(self._engine.device):
            op = self._engine.prepare(state.norm)
            # the stale set is unbounded across deltas while queries cap
            # work at max_batch — chunk the refresh the same way (f32
            # slabs) so a large accumulation cannot blow up memory inside
            # the lock
            nodes = list(hints)
            width = max(1, self.config.max_batch)
            for i in range(0, len(nodes), width):
                batch = nodes[i : i + width]
                Y = np.zeros((n, len(batch)), dtype=np.float32)
                F = np.empty_like(Y)
                for c, v in enumerate(batch):
                    Y[v, c] = 1.0
                    F[:, c] = hints[v]
                for _ in range(self.config.refresh_rounds):
                    F = self._engine.round(op, F, Y)
                for c, v in enumerate(batch):
                    self.columns.put_stale(v, F[:, c])
        return len(nodes)


def _current_device(device: torch.device):
    """``device`` as the calling thread's current card (a new thread
    starts on card 0); nothing to do on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _make_remap(old: NetworkState, new: NetworkState):
    """Old-layout → new-layout column scatter (types keep their prefixes)."""

    def remap(col: np.ndarray) -> np.ndarray:
        out = np.zeros(new.num_nodes, dtype=np.float64)
        for t, (o_off, o_n) in enumerate(zip(old.offsets, old.sizes)):
            out[new.offsets[t] : new.offsets[t] + o_n] = col[o_off : o_off + o_n]
        return out

    return remap
