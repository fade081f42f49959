"""Session: resolve a RunSpec once, run its stages (DESIGN.md §13).

A :class:`Session` is the one place a spec meets the runtime registries:

* the network is built once (scenario generate → disk cache, drugnet
  adapter, or ``.npz`` load) and normalized once;
* ONE engine is instantiated from the resolved backend and its
  ``prepare()`` operator cache is shared across ``solve()`` and
  ``serve()`` (both run on the same normalized-network identity), so a
  combined solve→serve run assembles and uploads the operator once
  instead of once per entry point;
* stages return typed :class:`~repro_torch.api.artifacts.Artifact` objects and
  :meth:`run` writes them under ``results/<run_id>/``.

Evaluation runs on a *sibling* engine with the same config: its folds
solve masked copies of the network, and letting those churn the main
engine's single-entry operator cache would force serve to re-prepare.

Every engine of a session runs on its ``device`` (``None`` = ``cuda:0``,
which raises without CUDA; the CPU only with ``device="cpu"``), and so
does the ``bench`` pass.  The ``sharded`` backend lays its mesh over the
world that exists (every rank under ``torchrun``) or starts a world of one
rank; only rank 0 writes run artifacts.  ``train`` runs the guarded
training loop on the session's device.  ``dryrun`` traces each cell's
census on the CPU (fake tensors, nothing allocated).  Every stage of the
reference is ported; a stage listed in ``_NOT_PORTED_STAGES`` would raise
``NotImplementedError`` naming its item of ``ROADMAP.md``'s queue A.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.artifacts import (
    Artifact,
    BenchArtifact,
    DryrunArtifact,
    EvalArtifact,
    ServeArtifact,
    SolveArtifact,
    TrainArtifact,
    _write_json,
)
from repro_torch.api.spec import BenchSpec, DryrunSpec, EvalSpec, RunSpec, ServeSpec, SpecError
from repro_torch.device import DeviceLike, resolve_device

_UNSET = object()
# run sections whose modules are not ported yet -> their ROADMAP.md item
_NOT_PORTED_STAGES: Dict[str, str] = {}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a stage raises while its modules are not ported yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue {item})"
    )


class Session:
    """A resolved RunSpec: shared network, shared engine, staged runs."""

    def __init__(
        self,
        spec: RunSpec,
        *,
        results_root: str = "results",
        bundle=None,
        device: DeviceLike = None,
    ):
        """``bundle`` injects an already-generated ScenarioBundle so
        multi-backend sweeps (the scenario CLI) pay generation once.
        ``device`` is where every engine of the session runs."""
        self.spec = spec
        self.device = resolve_device(device)
        self.run_id = spec.resolved_run_id()
        self.run_dir = os.path.join(results_root, self.run_id)
        self._bundle: Any = _UNSET if bundle is None else bundle
        self._network: Any = None if bundle is None else bundle.network
        self._norm: Any = None
        self._backend: Optional[str] = None
        self._engine: Any = None
        self._eval_engine: Any = None
        self._telemetry: Any = None
        self._watchdog: Any = None

    # ------------------------------------------------------------- network
    @property
    def bundle(self):
        """The ScenarioBundle behind the network (None for file loads)."""
        if self._bundle is _UNSET:
            self._resolve_network()
        return self._bundle

    @property
    def network(self):
        if self._network is None:
            self._resolve_network()
        return self._network

    @property
    def norm(self):
        """The one normalized view every stage shares (prepare-cache key)."""
        if self._norm is None:
            self._norm = self.network.normalize()
        return self._norm

    def _trace_coupled_params(self, sc) -> Dict[str, Any]:
        """Builder params, plus the serve replay's horizon/rate when the
        builder accepts them and the spec leaves them unset.

        Scenarios that schedule their own timed workload (streaming) must
        schedule it against THIS spec's replay horizon, or tail deltas
        would land past the last query and silently never apply — the
        invariant ``benchmarks/serve_bench.py`` has always kept.
        """
        ns = self.spec.network
        sv = self.spec.serve
        params = dict(ns.params)
        if sv is not None and sv.trace is not None:
            import inspect

            accepted = inspect.signature(sc.get_scenario(ns.name).fn).parameters
            for key, value in (
                ("horizon_s", sv.horizon_s),
                ("rate_qps", sv.rate_qps),
            ):
                if key in accepted and key not in params:
                    params[key] = value
        return params

    def _resolve_network(self) -> None:
        ns = self.spec.network
        if ns.kind == "scenario":
            import repro_torch.scenarios as sc

            bundle = sc.generate(
                ns.name,
                scale=ns.scale,
                seed=ns.seed,
                cache=ns.cache,
                **self._trace_coupled_params(sc),
            )
        elif ns.kind == "drugnet":
            from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
            from repro_torch.scenarios.base import ScenarioBundle

            try:
                dn = make_drugnet(DrugNetSpec(seed=ns.seed, **ns.params))
            except TypeError as e:
                raise SpecError(f"network.params: {e}") from e
            bundle = ScenarioBundle(
                name="drugnet",
                network=dn.network,
                truth=dn.truth or {},
                eval_pair=(0, 2),
                clusters=dn.clusters,
            )
        else:  # file
            from repro_torch.core.network import HeteroNetwork

            net = HeteroNetwork.load_npz(ns.path)
            self._bundle, self._network = None, net
            return
        self._bundle, self._network = bundle, bundle.network

    # -------------------------------------------------------------- engine
    def lp_config(self):
        """The session-wide LPConfig.

        ``seed_mode`` left unset resolves to ``"fixed"`` when the spec
        has a serve section — the whole session must then converge to
        the F0-independent fixed point, or solve and serve would answer
        from different math.
        """
        solve = self.spec.resolved_solve()
        seed_mode = solve.seed_mode
        if seed_mode is None and self.spec.serve is not None:
            seed_mode = "fixed"
        return solve.to_lp_config(seed_mode=seed_mode, backend=self.backend)

    @property
    def backend(self) -> str:
        """The resolved engine-registry key (``auto`` resolved once)."""
        if self._backend is None:
            from repro_torch.engine import resolve_backend

            solve = self.spec.resolved_solve()
            requested = solve.backend
            if requested is None and self.spec.serve is not None:
                requested = self.spec.serve.engine
            self._backend = resolve_backend(
                requested, num_nodes=self.network.num_nodes
            )
        return self._backend

    def _engine_kwargs(self) -> Dict[str, Any]:
        solve = self.spec.resolved_solve()
        if self.backend == "sharded" and solve.devices:
            return {"devices": solve.devices}
        return {}

    @property
    def engine(self):
        """The one prepared engine solve and serve share."""
        if self._engine is None:
            from repro_torch.engine import make_engine

            self._engine = make_engine(
                self.backend, self.lp_config(), device=self.device,
                **self._engine_kwargs(),
            )
        return self._engine

    @property
    def eval_engine(self):
        """Same config, separate operator cache (masked-fold churn)."""
        if self._eval_engine is None:
            from repro_torch.engine import make_engine

            self._eval_engine = make_engine(
                self.backend, self.lp_config(), device=self.device,
                **self._engine_kwargs(),
            )
        return self._eval_engine

    @property
    def telemetry(self):
        """The session-wide Telemetry (level from ``spec.obs``, else off).

        Always a live object: stage code records unconditionally and the
        off level suppresses at the sink (DESIGN.md §14.2's overhead
        policy), so there is exactly one instrumentation code path.
        """
        if self._telemetry is None:
            from repro_torch.obs import Telemetry

            obs = self.spec.obs
            level = obs.level if obs is not None else "off"
            export = obs.export if obs is not None else True
            self._telemetry = Telemetry(level, run_id=self.run_id, export=export)
        return self._telemetry

    def _network_desc(self) -> Dict[str, Any]:
        net = self.network
        ns = self.spec.network
        return {
            "kind": ns.kind,
            "name": ns.name or (ns.path if ns.kind == "file" else "drugnet"),
            "scale": ns.scale,
            "seed": ns.seed,
            "types": net.num_types,
            "nodes": net.num_nodes,
            "edges": net.num_edges,
        }

    def _rank_pair(self, explicit: Optional[Tuple[int, int]]) -> Tuple[int, int]:
        if explicit is not None:
            return explicit
        if self.bundle is not None:
            return tuple(self.bundle.eval_pair)
        return (0, self.network.num_types - 1)

    # ----------------------------------------------------- fault tolerance
    def ft_ckpt_dir(self, namespace: str) -> str:
        """Checkpoint root for one stage (``solve`` / ``serve``).

        Defaults under the run directory, so re-running the same spec with
        the same ``run_id`` (``repro_torch run --resume``) finds the durable
        steps without any extra plumbing; ``ft.ckpt_dir`` overrides for
        shared/scratch filesystems.
        """
        ft = self.spec.ft
        root = (
            ft.ckpt_dir
            if ft is not None and ft.ckpt_dir
            else os.path.join(self.run_dir, "checkpoints")
        )
        return os.path.join(root, namespace)

    def _checkpointed_solve(self):
        """The durable solve path (``spec.ft`` set): superstep barriers
        through a CheckpointManager, resume from the latest durable step."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.ft import FailureInjector, StragglerWatch
        from repro_torch.ft.solve import checkpointed_solve, supports_checkpointed

        ft = self.spec.ft
        if not supports_checkpointed(self.engine):
            raise SpecError(
                f"ft: backend {self.backend!r} has no engine.round "
                "contract — the checkpointed superstep loop needs it"
            )
        tel = self.telemetry
        straggler = StragglerWatch(
            alpha=ft.straggler_alpha,
            threshold=ft.straggler_threshold,
            telemetry=tel,
        )
        injector = (
            FailureInjector(fail_at=ft.inject_solve_fault)
            if ft.inject_solve_fault
            else None
        )
        manager = CheckpointManager(
            self.ft_ckpt_dir("solve"),
            keep_last=ft.keep_last,
            async_write=ft.async_write,
        )
        try:
            res, stats = checkpointed_solve(
                self.engine,
                self.norm,
                manager=manager,
                interval=ft.interval,
                telemetry=tel,
                injector=injector,
                straggler=straggler,
            )
        finally:
            # an injected (or real) mid-solve crash must still drain the
            # writer queue — the durable step is what --resume restarts from
            manager.close()
        stats["straggler_flags"] = straggler.slow_steps
        if injector is not None:
            stats["injected_faults"] = list(injector.fired)
        return res, stats

    # -------------------------------------------------------------- stages
    def solve(self) -> SolveArtifact:
        from repro_torch.core.ranking import extract_outputs

        solve = self.spec.resolved_solve()
        tel = self.telemetry
        t0 = time.perf_counter()
        ft_stats: Dict[str, Any] = {}
        if self.spec.ft is not None:
            res, ft_stats = self._checkpointed_solve()
        elif tel.enabled:
            from repro_torch.obs.solve import observed_solve, supports_observed

            if supports_observed(self.engine):
                # host-driven round loop: per-superstep residual/active
                # series for `repro_torch obs` (same fixed point, DESIGN.md §14.3)
                res = observed_solve(self.engine, self.norm, telemetry=tel)
            else:
                res = self.engine.run(self.norm)
                tel.count("solve.supersteps", int(res.supersteps))
        else:
            res = self.engine.run(self.norm)
        seconds = time.perf_counter() - t0
        outputs = extract_outputs(res.F, self.norm)
        pair = self._rank_pair(solve.rank_pair)
        top = outputs.ranked_candidates(pair, solve.entity, solve.top_k)
        i, j = pair
        if (i, j) in outputs.interactions:
            row = outputs.interactions[(i, j)][solve.entity]
        else:
            row = outputs.interactions[(j, i)][:, solve.entity]
        scores = np.asarray(row[top], dtype=np.float64)
        return SolveArtifact(
            run_id=self.run_id,
            seconds=seconds,
            backend=self.backend,
            alg=solve.alg,
            converged=bool(res.converged),
            outer_iters=int(res.outer_iters),
            inner_iters=int(res.inner_iters),
            supersteps=int(res.supersteps),
            network=self._network_desc(),
            ranking={
                "pair": list(pair),
                "entity": solve.entity,
                "top_k": solve.top_k,
                "candidates": [int(c) for c in top],
                "scores": [float(s) for s in scores],
            },
            ft=ft_stats,
            F=res.F,
            outputs=outputs,
        )

    def evaluate(self) -> EvalArtifact:
        import repro_torch.scenarios as sc
        from repro_torch.eval.cv import summarize

        ev = self.spec.eval if self.spec.eval is not None else EvalSpec()
        if self.bundle is None or not self.bundle.truth:
            raise SpecError(
                "evaluate() needs planted ground truth — "
                f"network kind {self.spec.network.kind!r} has none"
            )
        pair = ev.pair or tuple(self.bundle.eval_pair)
        t0 = time.perf_counter()
        if ev.protocol == "recovery":
            problem = sc.make_recovery_problem(
                self.bundle,
                pair,
                holdout_frac=ev.holdout_frac,
                max_entities=ev.max_entities,
                seed=ev.seed,
            )
            res = self.eval_engine.run(problem.masked_net, seeds=problem.Y)
            metrics = problem.metrics(res.F)
            metrics["outer_iters"] = float(res.outer_iters)
            F = res.F
            params = {
                "holdout_frac": ev.holdout_frac,
                "max_entities": ev.max_entities,
                "seed": ev.seed,
            }
        else:  # cv
            results = sc.scenario_cross_validate(
                self.bundle,
                pair=pair,
                backend=self.backend,
                k=ev.folds,
                seed=ev.seed,
                lp=self.lp_config(),
                engine=self.eval_engine,
                device=self.device,
            )
            metrics = summarize(results)
            F = None
            params = {"folds": ev.folds, "seed": ev.seed}
        return EvalArtifact(
            run_id=self.run_id,
            seconds=time.perf_counter() - t0,
            protocol=ev.protocol,
            backend=self.backend,
            pair=tuple(pair),
            params=params,
            metrics={k: float(v) for k, v in metrics.items()},
            F=F,
        )

    # --------------------------------------------------------------- serve
    def serve_engine(self, sv: Optional[ServeSpec] = None):
        """An LPServeEngine wired to the session's prepared engine."""
        from repro_torch.serve import LPServeEngine, ServeConfig

        sv = sv or self.spec.serve or ServeSpec()
        cfg = ServeConfig(
            lp=self.lp_config(),
            cache_columns=sv.cache_columns,
            cache_shards=sv.cache_shards,
            warm_start=sv.warm_start,
            refresh_rounds=sv.refresh_rounds,
            max_batch=sv.max_batch,
            max_wait_s=sv.max_wait_ms / 1e3,
            queue_depth=sv.queue_depth,
            pipeline_depth=sv.pipeline_depth,
            early_exit=sv.resolved_early_exit(self.spec.resolved_solve()),
        )
        engine = LPServeEngine(
            self.network,
            cfg,
            engine=self.engine,
            norm=self.norm,
            telemetry=self.telemetry,
            device=self.device,
        )
        ft = self.spec.ft
        if ft is not None:
            from repro_torch.checkpoint import CheckpointManager
            from repro_torch.ft import FailureInjector, StepGuard, StragglerWatch

            engine.enable_ft(
                guard=StepGuard(
                    max_retries=ft.max_retries,
                    backoff_s=ft.backoff_s,
                    telemetry=self.telemetry,
                ),
                straggler=StragglerWatch(
                    alpha=ft.straggler_alpha,
                    threshold=ft.straggler_threshold,
                    telemetry=self.telemetry,
                ),
                injector=(
                    FailureInjector(fail_at=ft.inject_serve_fault)
                    if ft.inject_serve_fault
                    else None
                ),
                manager=CheckpointManager(
                    self.ft_ckpt_dir("serve"),
                    keep_last=ft.keep_last,
                    async_write=ft.async_write,
                ),
                interval=ft.interval,
            )
        obs = self.spec.obs
        if obs is not None and obs.slo is not None:
            from repro_torch.obs import ServeDegradation, SLOWatchdog

            if self._watchdog is not None:
                # bench sweeps build several engines per session; only the
                # newest one's knobs should answer to the watchdog
                self._watchdog.detach()
            self._watchdog = SLOWatchdog.from_spec(
                obs.slo,
                self.telemetry,
                degradation=ServeDegradation(engine),
            ).attach()
        return engine


    def serve(self) -> ServeArtifact:
        from repro_torch.serve.replay import play_zipf, replay_trace

        sv = self.spec.serve if self.spec.serve is not None else ServeSpec()
        engine = self.serve_engine(sv)
        t0 = time.perf_counter()
        try:
            if sv.trace is not None:
                import repro_torch.scenarios as sc

                if self.bundle is None:
                    raise SpecError(
                        "serve.trace replay needs a scenario/drugnet network "
                        "(file networks carry no trace schema)"
                    )
                trace = sc.build_trace(
                    self.bundle,
                    sv.trace,
                    rate_qps=sv.rate_qps,
                    horizon_s=sv.horizon_s,
                    seed=self.spec.network.seed,
                )
                if len(trace) == 0:
                    raise SpecError(
                        f"serve.trace: the {sv.trace} trace came out empty "
                        f"(rate_qps={sv.rate_qps}, horizon_s={sv.horizon_s}); "
                        "raise one of them"
                    )
                report = replay_trace(
                    engine,
                    trace,
                    self.bundle.deltas if sv.apply_deltas else (),
                    top_k=sv.top_k,
                    time_scale=sv.time_scale,
                    priority=sv.priority,
                    telemetry=self.telemetry,
                )
                mode = "trace"
            else:
                pair = self._rank_pair(None)
                src = sv.source_type if sv.source_type is not None else pair[0]
                dst = sv.target_type if sv.target_type is not None else pair[1]
                for knob, t in (("source_type", src), ("target_type", dst)):
                    if t >= self.network.num_types:
                        raise SpecError(
                            f"serve.{knob}={t} out of range: the network has "
                            f"{self.network.num_types} node types"
                        )
                if src == dst:
                    raise SpecError(
                        f"serve.source_type == serve.target_type == {src}; "
                        "the zipf workload ranks a cross-type interaction"
                    )
                report = play_zipf(
                    engine,
                    source_type=src,
                    target_type=dst,
                    requests=sv.requests,
                    zipf=sv.zipf,
                    deltas=sv.deltas,
                    top_k=sv.top_k,
                    seed=self.spec.network.seed,
                    telemetry=self.telemetry,
                )
                mode = "zipf"
        finally:
            # final cache snapshot + writer-thread shutdown (no-op with
            # ft disabled); stats stay readable for the artifact below
            engine.close_ft()
        seconds = time.perf_counter() - t0
        sample = report.pop("sample", {})
        report.pop("latencies", None)  # raw samples stay in memory only
        return ServeArtifact(
            run_id=self.run_id,
            seconds=seconds,
            mode=mode,
            engine=self.backend,
            report=report,
            sample=sample,
            slo=self._watchdog.report() if self._watchdog is not None else {},
            ft=engine.ft_stats(),
        )

    # ------------------------------------------- bench / train / dryrun
    def bench(self, *, write: bool = True) -> BenchArtifact:
        """Run the spec's ``bench`` section (every suite when absent) on
        the session's device."""
        from repro_torch.bench.driver import run_bench

        bench = self.spec.bench if self.spec.bench is not None else BenchSpec()
        t0 = time.perf_counter()
        outcome = run_bench(
            fast=bench.fast,
            only=list(bench.suites) if bench.suites else None,
            label=bench.resolved_label(),
            write=write,
            device=self.device,
        )
        return BenchArtifact(
            run_id=self.run_id,
            seconds=time.perf_counter() - t0,
            label=bench.resolved_label(),
            suites=outcome.suites,
            records=outcome.records,
            failures=outcome.failures,
            report_paths=outcome.paths,
        )

    def train(self, *, echo=print) -> TrainArtifact:
        """Run the guarded training loop for the spec's ``train`` section
        on the session's device.

        Training never touches the LP network/engine machinery: the
        section runs standalone (a networkless spec is valid), and
        lp-family archs are rejected in :func:`~repro_torch.launch.train.
        run_training` because they converge via the solve stage, not SGD.
        ``echo`` receives the per-step progress lines.
        """
        if self.spec.train is None:
            raise SpecError("run section 'train' needs a train section in the spec")
        from repro_torch.launch.train import run_training

        t0 = time.perf_counter()
        stats = run_training(self.spec.train, echo=echo, device=self.device)
        return TrainArtifact(
            run_id=self.run_id,
            seconds=time.perf_counter() - t0,
            arch=str(stats["arch"]),
            family=str(stats["family"]),
            steps=int(stats["steps"]),
            first_loss=float(stats["first_loss"]),
            last_loss=float(stats["last_loss"]),
            retries=int(stats["retries"]),
            restores=int(stats["restores"]),
            slow_steps=int(stats["slow_steps"]),
            resumed=bool(stats["resumed"]),
        )

    def dryrun(self) -> DryrunArtifact:
        """Census-sweep the configured (arch × shape × mesh) cells
        (:func:`repro_torch.launch.dryrun.run_cell`: each step traced on
        fake DTensors over the production mesh, on the CPU whatever the
        session's device).

        The census lands in the telemetry artifact format (see
        :class:`DryrunArtifact`); the ``roofline`` suite reads it through
        ``REPRO_DRYRUN_ARTIFACTS``.
        """
        from repro_torch.configs import all_cells, get_arch
        from repro_torch.launch.dryrun import run_cell

        dr = self.spec.dryrun if self.spec.dryrun is not None else DryrunSpec()
        if dr.archs:
            cells = []
            for arch in dr.archs:
                shapes = dr.shapes or tuple(get_arch(arch).shapes)
                cells.extend((arch, s) for s in shapes)
        else:
            cells = all_cells(include_extra=dr.include_extra)
        meshes = ["single", "multi"] if dr.mesh == "both" else [dr.mesh]

        tel = self.telemetry
        t0 = time.perf_counter()
        recs: List[Dict[str, Any]] = []
        offsets: List[float] = []
        for arch, shape in cells:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind)
                recs.append(rec)
                offsets.append(time.perf_counter() - t0)
                tel.event("dryrun.cell", arch=arch, shape=shape, mesh=mesh_kind,
                          status=rec.get("status"), lower_s=rec.get("lower_s"))
        return DryrunArtifact(
            run_id=self.run_id,
            seconds=time.perf_counter() - t0,
            mesh=dr.mesh,
            cells=recs,
            offsets=offsets,
        )

    # ----------------------------------------------------------------- run
    def run(
        self,
        sections: Optional[List[str]] = None,
        *,
        write: bool = True,
        echo=print,
    ) -> List[Artifact]:
        """Execute the spec's configured stages in order.

        Writes ``spec.json`` + one artifact file per stage under
        ``results/<run_id>/`` unless ``write=False``.
        """
        stages = {
            "solve": self.solve,
            "eval": self.evaluate,
            "serve": self.serve,
            # bench honors the run-level write flag: --no-write must not
            # leave BENCH_<label>.json behind either
            "bench": lambda: self.bench(write=write),
            "train": lambda: self.train(echo=echo),
            "dryrun": self.dryrun,
        }
        names = list(sections) if sections else list(self.spec.sections())
        unknown = [n for n in names if n not in stages]
        if unknown:
            raise SpecError(f"unknown run section(s) {unknown}")
        # refuse what is not ported before anything runs or is written
        for name in names:
            if name in _NOT_PORTED_STAGES:
                raise not_ported(f"the {name} section", _NOT_PORTED_STAGES[name])
        if "bench" in names and self.spec.bench is not None:
            from repro_torch.bench.driver import refuse_unported

            refuse_unported(self.spec.bench.suites)
        serve_engine = self.spec.serve.engine if self.spec.serve else None
        if "sharded" in (self.spec.resolved_solve().backend, serve_engine):
            from repro_torch.parallel.mesh import is_rank_zero

            write = write and is_rank_zero()  # one set of artifacts per world
        if write:
            os.makedirs(self.run_dir, exist_ok=True)
            _write_json(os.path.join(self.run_dir, "spec.json"), self.spec.to_dict())

        tel = self.telemetry
        tel_dir = os.path.join(self.run_dir, "telemetry")
        obs = self.spec.obs
        if (
            write
            and tel.enabled
            and obs is not None
            and obs.flush_interval_s is not None
        ):
            # live mode: telemetry/<run_id> becomes readable mid-run and
            # the SLO watchdog (if any) gets its per-window flush ticks
            tel.attach_stream(tel_dir, interval_s=obs.flush_interval_s)
        if tel.profile_enabled:
            from repro_torch.obs.profiler import install_kernel_hook

            install_kernel_hook(tel)
        artifacts: List[Artifact] = []
        try:
            with tel.span("run", self.run_id, sections=list(names)):
                for name in names:
                    with tel.span("phase", name):
                        if name in ("solve", "serve") and tel.profile_enabled:
                            from repro_torch.obs.profiler import profile_phase

                            with profile_phase(tel, tel_dir, name, self.device):
                                art = stages[name]()
                        else:
                            art = stages[name]()
                    artifacts.append(art)
                    if write:
                        for path in art.write(self.run_dir):
                            echo(f"[{name}] wrote {path}")
        finally:
            if tel.profile_enabled:
                from repro_torch.obs.profiler import uninstall_kernel_hook

                uninstall_kernel_hook()
        if write and tel.enabled:
            for path in tel.flush(tel_dir):
                echo(f"[obs] wrote {path}")
        return artifacts
