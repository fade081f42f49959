"""The one ``repro_torch`` driver: ``python -m repro_torch run <spec.json|flags>``.

Every workflow the repo has — one-shot solve, recovery/CV evaluation,
online serving, benchmark passes — executes through a declarative
:class:`~repro_torch.api.spec.RunSpec` resolved by a
:class:`~repro_torch.api.session.Session` (DESIGN.md §13).  This module is the
thin argparse layer over that API:

* ``run``       — the driver: a spec file, or flags that build one;
* ``obs``       — render/validate a run's telemetry (DESIGN.md §14);
* ``solve``, ``serve``, ``scenario``, ``bench`` — legacy-surface
  subcommands: the flag surfaces of the retired
  ``repro_torch.launch.*`` module entry points (and of
  ``benchmarks/run.py``), kept as positional subcommands.

A spec section, backend or bench suite whose modules are not ported yet
exits 2 and names its item of ``ROADMAP.md``'s queue A.

Every subcommand that solves takes ``--device`` (default ``cuda``; there
is no fallback to the CPU, which runs only with ``--device cpu``).

The legacy subcommands emit a ``DeprecationWarning``, build a RunSpec,
and execute it through the same Session the driver uses — rankings are
byte-identical to the scripts they replaced.  The old module entry
points (``python -m repro_torch.launch.solve`` etc.) are retired and exit
with a migration hint (:mod:`repro_torch.launch._removed`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from typing import Any, Dict, List, Optional

from repro_torch.bench.matrix import AGREEMENT_TOL

ARRIVAL_CHOICES = ("poisson", "bursty", "diurnal")


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the engines run: cuda (default, cuda:0), cuda:<k> or cpu",
    )


def _warn_deprecated(old: str, hint: str) -> None:
    warnings.warn(
        f"{old} is deprecated — use `python -m repro_torch run` ({hint})",
        DeprecationWarning,
        stacklevel=3,
    )


def _split_csv(s: Optional[str]) -> Optional[List[str]]:
    if s is None:
        return None
    return [p.strip() for p in s.split(",") if p.strip()]


def _parse_pair(s: Optional[str], flag: str) -> Optional[List[int]]:
    if s is None:
        return None
    parts = s.split(",")
    if len(parts) != 2:
        raise SystemExit(f"{flag} expects 'i,j', got {s!r}")
    return [int(p) for p in parts]


# --------------------------------------------------------------------------
# repro_torch run
# --------------------------------------------------------------------------
def _run_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch run",
        description="Execute a declarative RunSpec (file or flag-built).",
    )
    ap.add_argument(
        "spec",
        nargs="?",
        default=None,
        help="RunSpec JSON file; omit to build one from flags",
    )
    ap.add_argument(
        "--only",
        default=None,
        help="comma-separated subset of the spec's sections "
        "(solve,eval,serve,bench)",
    )
    ap.add_argument(
        "--results-root",
        default="results",
        help="artifact root (default: results/)",
    )
    ap.add_argument("--run-id", default=None)
    _add_device(ap)
    ap.add_argument(
        "--resume",
        default=None,
        metavar="RUN_ID",
        help="restart a checkpointed run: reload "
        "<results-root>/<RUN_ID>/spec.json and continue from the latest "
        "durable step (the spec needs an ft section)",
    )
    ap.add_argument(
        "--no-write",
        action="store_true",
        help="skip writing results/<run_id>/ artifacts",
    )
    ap.add_argument(
        "--dry-run",
        action="store_true",
        help="print the resolved spec JSON and exit",
    )
    # ---- network
    ap.add_argument(
        "--network",
        default=None,
        metavar="KIND[:NAME]",
        help="drugnet | scenario:<name> | file:<path>",
    )
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument(
        "--param",
        action="append",
        default=None,
        metavar="KEY=JSON",
        help="network builder parameter (repeatable)",
    )
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help="bypass the scenario disk cache",
    )
    # ---- solve
    ap.add_argument("--alg", choices=["dhlp1", "dhlp2"], default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--sigma", type=float, default=None)
    ap.add_argument("--mode", choices=["batched", "sequential"], default=None)
    ap.add_argument("--seed-mode", choices=["fixed", "drift"], default=None)
    ap.add_argument(
        "--backend",
        "--engine",
        dest="backend",
        default=None,
        help="engine-registry backend key (or 'auto')",
    )
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--momentum", type=float, default=None)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--entity", type=int, default=None)
    ap.add_argument("--rank-pair", default=None, metavar="I,J")
    # ---- eval
    ap.add_argument("--eval", choices=["recovery", "cv"], default=None)
    ap.add_argument("--folds", type=int, default=None)
    ap.add_argument("--holdout-frac", type=float, default=None)
    ap.add_argument("--max-entities", type=int, default=None)
    ap.add_argument("--pair", default=None, metavar="I,J")
    # ---- serve
    ap.add_argument(
        "--serve",
        nargs="?",
        const="zipf",
        default=None,
        choices=("zipf",) + ARRIVAL_CHOICES,
        help="play a workload: zipf (synthetic) or a trace arrival process",
    )
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--zipf", type=float, default=None)
    ap.add_argument("--deltas", type=int, default=None)
    ap.add_argument("--rate-qps", type=float, default=None)
    ap.add_argument("--horizon", type=float, default=None)
    ap.add_argument("--time-scale", type=float, default=None)
    ap.add_argument("--refresh-rounds", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument(
        "--pipeline-depth",
        type=int,
        default=None,
        help="batches in flight (1 = synchronous tick, 2 = double-buffered)",
    )
    ap.add_argument(
        "--cache-shards",
        type=int,
        default=None,
        help="independently-locked column-cache shards",
    )
    ap.add_argument(
        "--early-exit",
        choices=("auto", "on", "off"),
        default=None,
        help="per-column convergence early exit in batch solves",
    )
    ap.add_argument(
        "--priority",
        choices=("interactive", "refresh", "bulk"),
        default=None,
        help="admission class stamped on replayed queries",
    )
    ap.add_argument(
        "--source-type",
        type=int,
        default=None,
        help="zipf workload: query entities of this type (default: eval pair)",
    )
    ap.add_argument(
        "--target-type",
        type=int,
        default=None,
        help="zipf workload: rank candidates of this type (default: eval pair)",
    )
    # ---- obs
    ap.add_argument(
        "--obs",
        nargs="?",
        const="metrics",
        default=None,
        choices=("off", "metrics", "trace", "profile"),
        help="telemetry level; bare --obs means 'metrics' (DESIGN.md §14)",
    )
    # ---- bench
    ap.add_argument(
        "--bench",
        nargs="?",
        const="all",
        default=None,
        metavar="SUITES",
        help="run registered bench suites (comma list or 'all')",
    )
    ap.add_argument(
        "--full",
        action="store_true",
        help="bench at paper scale",
    )
    ap.add_argument("--label", default=None, help="bench report label")
    return ap


_SPEC_FILE_OK = {
    "spec", "only", "results_root", "run_id", "no_write", "dry_run", "resume",
    "device",
}


def _build_spec_dict(args) -> Dict:
    """Assemble a RunSpec dict from builder flags."""
    from repro_torch.api.spec import SpecError

    net: Dict = {}
    if args.network:
        kind, _, name = args.network.partition(":")
        net["kind"] = kind
        if kind == "scenario" and name:
            net["name"] = name
        elif kind == "file" and name:
            net["path"] = name
        elif name:
            raise SpecError(
                f"--network {args.network!r}: only scenario/file take a "
                "':<name>' suffix"
            )
    else:
        net["kind"] = "drugnet"
    if args.scale is not None:
        net["scale"] = args.scale
    if args.seed is not None:
        net["seed"] = args.seed
    if args.param:
        params = {}
        for kv in args.param:
            key, eq, val = kv.partition("=")
            if not eq:
                raise SpecError(f"--param {kv!r}: expected KEY=JSON")
            try:
                params[key] = json.loads(val)
            except json.JSONDecodeError:
                params[key] = val  # bare strings allowed
        net["params"] = params
    if args.no_cache:
        net["cache"] = False

    solve: Dict = {}
    for flag, key in (
        ("alg", "alg"),
        ("alpha", "alpha"),
        ("sigma", "sigma"),
        ("mode", "mode"),
        ("seed_mode", "seed_mode"),
        ("backend", "backend"),
        ("devices", "devices"),
        ("momentum", "momentum"),
        ("top_k", "top_k"),
        ("entity", "entity"),
    ):
        v = getattr(args, flag)
        if v is not None:
            solve[key] = v
    if args.rank_pair is not None:
        solve["rank_pair"] = _parse_pair(args.rank_pair, "--rank-pair")

    ev: Dict = {}
    if args.eval:
        ev["protocol"] = args.eval
    if args.folds is not None:
        ev["folds"] = args.folds
    if args.holdout_frac is not None:
        ev["holdout_frac"] = args.holdout_frac
    if args.max_entities is not None:
        ev["max_entities"] = args.max_entities
    if args.pair is not None:
        ev["pair"] = _parse_pair(args.pair, "--pair")

    srv: Dict = {}
    if args.serve and args.serve != "zipf":
        srv["trace"] = args.serve  # zipf == the trace-less default
    for flag, key in (
        ("requests", "requests"),
        ("zipf", "zipf"),
        ("deltas", "deltas"),
        ("rate_qps", "rate_qps"),
        ("horizon", "horizon_s"),
        ("time_scale", "time_scale"),
        ("refresh_rounds", "refresh_rounds"),
        ("max_batch", "max_batch"),
        ("pipeline_depth", "pipeline_depth"),
        ("cache_shards", "cache_shards"),
        ("priority", "priority"),
        ("source_type", "source_type"),
        ("target_type", "target_type"),
    ):
        v = getattr(args, flag)
        if v is not None:
            srv[key] = v
    if args.early_exit is not None:
        # the tri-state maps onto ServeSpec.early_exit's None/bool
        srv["early_exit"] = {"auto": None, "on": True, "off": False}[
            args.early_exit
        ]

    bench: Dict = {}
    if args.bench:
        if args.bench != "all":
            bench["suites"] = _split_csv(args.bench)
        bench["fast"] = not args.full
        if args.label:
            bench["label"] = args.label

    # sub-flags never create a stage on their own: `--folds 4` without
    # `--eval cv` (or `--requests` without `--serve`) would otherwise
    # silently run a stage — or a protocol — the user never asked for
    if ev and not args.eval:
        raise SpecError(
            f"eval flags {sorted(ev)} require --eval <recovery|cv>"
        )
    if srv and not args.serve:
        raise SpecError(
            f"serve flags {sorted(srv)} require --serve [zipf|<process>]"
        )

    out: Dict = {"network": net}
    if solve:
        out["solve"] = solve
    if args.eval:
        out["eval"] = ev
    if args.serve:
        out["serve"] = srv
    if bench:
        out["bench"] = bench
    if args.obs:
        out["obs"] = {"level": args.obs}
    if args.run_id:
        out["run_id"] = args.run_id
    return out


def _describe(art) -> List[str]:
    """Human summary lines for one artifact."""
    k = art.kind
    if k == "solve":
        r = art.ranking
        out = [
            f"[solve] {art.alg} on {art.backend}: converged={art.converged} "
            f"outer={art.outer_iters} inner={art.inner_iters} "
            f"supersteps={art.supersteps} in {art.seconds:.2f}s",
            f"[solve] top-{r['top_k']} of type {r['pair'][1]} for entity "
            f"{r['entity']}: {r['candidates']}",
        ]
        if getattr(art, "ft", None):
            ft = art.ft
            line = f"[solve] ft: checkpoints={ft.get('checkpoints', 0)}"
            if ft.get("resumed_from") is not None:
                line += f" resumed_from={ft['resumed_from']}"
            out.append(line)
        return out
    if k == "eval":
        metrics = " ".join(
            f"{key}={val:.4f}" for key, val in sorted(art.metrics.items())
        )
        return [
            f"[eval] {art.protocol} on {art.backend} pair={list(art.pair)}: "
            f"{metrics} ({art.seconds:.2f}s)"
        ]
    if k == "serve":
        r = art.report
        line = (
            f"[serve] {art.mode} on {art.engine}: {r['queries']} queries "
            f"→ {r['qps']:.1f} QPS  p50={r['p50'] * 1e3:.2f}ms "
            f"p95={r['p95'] * 1e3:.2f}ms p99={r['p99'] * 1e3:.2f}ms"
        )
        if "offered_qps" in r:
            line += f"  offered={r['offered_qps']:.1f}"
        if "achieved_vs_offered" in r:
            line += f"  achieved/offered={r['achieved_vs_offered']:.2f}"
        src = ", ".join(f"{s}:{n}" for s, n in sorted(r["sources"].items()))
        out = [line, f"[serve] sources: {src}"]
        if getattr(art, "ft", None):
            ft = art.ft
            out.append(
                f"[serve] ft: checkpoints={ft.get('checkpoints', 0)} "
                f"retries={ft.get('retries', 0)} "
                f"restores={ft.get('restores', 0)}"
            )
        return out
    if k == "bench":
        return [
            f"[bench] label={art.label} suites={len(art.suites)} "
            f"records={art.records} failures={art.failures}"
        ]
    if k == "train":
        return [
            f"[train] {art.arch} ({art.family}): {art.steps} steps "
            f"loss {art.first_loss:.4f}→{art.last_loss:.4f} "
            f"retries={art.retries} restores={art.restores} "
            f"slow={art.slow_steps}{' resumed' if art.resumed else ''} "
            f"({art.seconds:.1f}s)"
        ]
    if k == "dryrun":
        s = art.summary()
        statuses = " ".join(f"{k}:{v}" for k, v in sorted(s["statuses"].items()))
        return [
            f"[dryrun] {s['cells']} cells on mesh={art.mesh}: {statuses} "
            f"({art.seconds:.1f}s)"
        ]
    return [f"[{k}] done in {art.seconds:.2f}s"]


def run_main(argv: Optional[List[str]] = None) -> int:
    ap = _run_parser()
    args = ap.parse_args(argv)

    from repro_torch.api import RunSpec, Session, SpecError

    try:
        if args.spec is not None or args.resume is not None:
            # a spec file (or a stored one, via --resume) is authoritative:
            # builder flags would silently fork it, so they are rejected
            builder_set = [
                f"--{k.replace('_', '-')}"
                for k, v in vars(args).items()
                # identity checks: 0 and 0.0 are real flag values, not
                # absent ones (0 == False would slip through `not in`)
                if k not in _SPEC_FILE_OK
                and v is not None
                and v is not False
            ]
            if builder_set:
                ap.error(
                    f"spec file given; builder flags {builder_set} conflict "
                    "(edit the spec instead)"
                )
        if args.resume is not None:
            if args.spec is not None:
                ap.error("--resume reloads the stored spec; drop the spec file")
            if args.run_id:
                ap.error("--resume fixes the run id; drop --run-id")
            stored = os.path.join(args.results_root, args.resume, "spec.json")
            if not os.path.isfile(stored):
                raise SpecError(
                    f"--resume {args.resume}: no stored spec at {stored}"
                )
            spec = RunSpec.from_file(stored)
            if spec.ft is None:
                raise SpecError(
                    f"--resume {args.resume}: the stored spec has no ft "
                    "section — nothing was checkpointed"
                )
            # the run id pins both the artifact dir and the default
            # checkpoint root the resumed solve restores from
            spec = RunSpec.from_dict({**spec.to_dict(), "run_id": args.resume})
        elif args.spec is not None:
            spec = RunSpec.from_file(args.spec)
            if args.run_id:
                spec = RunSpec.from_dict({**spec.to_dict(), "run_id": args.run_id})
        else:
            spec = RunSpec.from_dict(_build_spec_dict(args))
    except (SpecError, OSError) as e:
        print(f"repro_torch run: {e}", file=sys.stderr)
        return 2

    if args.dry_run:
        print(spec.to_json())
        return 0

    try:
        session = Session(spec, results_root=args.results_root, device=args.device)
    except RuntimeError as e:  # CUDA asked for and missing
        print(f"repro_torch run: {e}", file=sys.stderr)
        return 2
    try:
        artifacts = session.run(
            sections=_split_csv(args.only), write=not args.no_write
        )
    except SpecError as e:
        print(f"repro_torch run: {e}", file=sys.stderr)
        return 2
    failures = 0
    for art in artifacts:
        for line in _describe(art):
            print(line)
        failures += getattr(art, "failures", 0)
    return 1 if failures else 0


# --------------------------------------------------------------------------
# repro_torch solve (deprecation shim for repro_torch.launch.solve)
# --------------------------------------------------------------------------
def solve_main(argv: Optional[List[str]] = None) -> int:
    _warn_deprecated(
        "the standalone solve CLI",
        "e.g. `python -m repro_torch run --alg dhlp2 --backend dense`",
    )
    ap = argparse.ArgumentParser(prog="repro_torch solve")
    ap.add_argument("--alg", choices=["dhlp1", "dhlp2"], default="dhlp2")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sigma", type=float, default=1e-3)
    ap.add_argument("--mode", choices=["batched", "sequential"], default="batched")
    ap.add_argument(
        "--backend",
        "--engine",
        dest="backend",
        default="dense",
        help="engine-registry backend "
        "(dense/sparse/kernel/sharded/auto)",
    )
    ap.add_argument(
        "--devices",
        type=int,
        default=None,
        help="edge-shard count for --backend sharded",
    )
    ap.add_argument("--drugs", type=int, default=223)
    ap.add_argument("--diseases", type=int, default=150)
    ap.add_argument("--targets", type=int, default=95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument(
        "--entity",
        type=int,
        default=0,
        help="drug id whose target ranking is printed",
    )
    ap.add_argument("--out", default=None, help="write outputs npz here")
    _add_device(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.api import NetworkSpec, RunSpec, Session, SolveSpec, SpecError

    try:
        spec = RunSpec(
            network=NetworkSpec(
                kind="drugnet",
                seed=args.seed,
                params={
                    "n_drug": args.drugs,
                    "n_disease": args.diseases,
                    "n_target": args.targets,
                },
            ),
            solve=SolveSpec(
                alg=args.alg,
                alpha=args.alpha,
                sigma=args.sigma,
                mode=args.mode,
                backend=args.backend,
                devices=(args.devices if args.backend == "sharded" else None),
                top_k=args.top_k,
                entity=args.entity,
                rank_pair=(0, 2),
            ),
        )
        session = Session(spec, device=args.device)
        net = session.network
        print(f"[solve] network: {net.sizes} nodes/type, {net.num_edges} edges")
        print(f"[solve] backend: {session.backend}")
    except (SpecError, ValueError, RuntimeError) as e:
        # bad spec / unknown backend / no CUDA == usage error; anything
        # raised by the solve itself below is a real failure and keeps its
        # traceback
        ap.error(str(e))
    art = session.solve()
    print(
        f"[solve] {art.alg} converged={art.converged} "
        f"outer={art.outer_iters} inner={art.inner_iters} "
        f"supersteps={art.supersteps} in {art.seconds:.2f}s"
    )
    names = {
        (0, 1): "drug-disease",
        (0, 2): "drug-target",
        (1, 2): "disease-target",
    }
    out = art.outputs
    for pair, name in names.items():
        m = out.interactions[pair]
        print(f"[solve] {name}: {m.shape}, mean score {m.mean():.4g}")
    top = art.ranking["candidates"]
    print(f"[solve] top-{args.top_k} targets for drug {args.entity}: {top}")
    if args.out:
        np.savez_compressed(
            args.out,
            drug_disease=out.interactions[(0, 1)],
            drug_target=out.interactions[(0, 2)],
            disease_target=out.interactions[(1, 2)],
            sim_drug=out.similarities[0],
            sim_disease=out.similarities[1],
            sim_target=out.similarities[2],
        )
        print(f"[solve] outputs written to {args.out}")
    return 0


# --------------------------------------------------------------------------
# repro_torch serve (deprecation shim for repro_torch.launch.serve)
# --------------------------------------------------------------------------
def serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch serve")
    ap.add_argument("--alg", choices=["dhlp1", "dhlp2"], default="dhlp2")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sigma", type=float, default=1e-3)
    ap.add_argument(
        "--engine",
        choices=["dense", "sparse", "kernel", "sharded", "auto"],
        default="dense",
        help="engine-registry backend (sharded uses the host's devices)",
    )
    ap.add_argument(
        "--refresh-rounds",
        type=int,
        default=0,
        help="fused LP rounds to advance stale hints after each delta",
    )
    ap.add_argument("--drugs", type=int, default=223)
    ap.add_argument("--diseases", type=int, default=150)
    ap.add_argument("--targets", type=int, default=95)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument(
        "--requests",
        type=int,
        default=200,
        help="number of queries to play",
    )
    ap.add_argument(
        "--zipf",
        type=float,
        default=1.3,
        help="popularity skew; higher = more repeat queries",
    )
    ap.add_argument(
        "--deltas",
        type=int,
        default=0,
        help="graph edits interleaved through the workload",
    )
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--cache-columns", type=int, default=4096)
    ap.add_argument("--no-warm-start", action="store_true")
    _add_device(ap)
    return ap


def serve_main(argv: Optional[List[str]] = None) -> int:
    _warn_deprecated(
        "the standalone serve CLI",
        "e.g. `python -m repro_torch run --serve --requests 200`",
    )
    ap = serve_parser()
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.zipf <= 1.0:
        ap.error("--zipf must be > 1 (numpy zipf exponent)")

    from repro_torch.api import (
        NetworkSpec,
        RunSpec,
        ServeSpec,
        Session,
        SolveSpec,
        SpecError,
    )

    try:
        spec = RunSpec(
            network=NetworkSpec(
                kind="drugnet",
                seed=args.seed,
                params={
                    "n_drug": args.drugs,
                    "n_disease": args.diseases,
                    "n_target": args.targets,
                },
            ),
            solve=SolveSpec(
                alg=args.alg,
                alpha=args.alpha,
                sigma=args.sigma,
                seed_mode="fixed",
                backend=args.engine,
            ),
            serve=ServeSpec(
                requests=args.requests,
                zipf=args.zipf,
                deltas=args.deltas,
                top_k=args.top_k,
                cache_columns=args.cache_columns,
                warm_start=not args.no_warm_start,
                refresh_rounds=args.refresh_rounds,
                max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms,
                queue_depth=args.queue_depth,
            ),
        )
        session = Session(spec, device=args.device)
        net = session.network
        print(f"[serve] network: {net.sizes} nodes/type, {net.num_edges} edges")
        _ = session.backend  # resolve now: unknown engine == usage error
    except (SpecError, ValueError, RuntimeError) as e:
        ap.error(str(e))
    art = session.serve()
    r = art.report
    for ev in r["deltas"]:
        print(
            f"[serve] delta @req {ev['at']}: +assoc drug {ev['u']} → "
            f"target {ev['v']} (version {ev['version']})"
        )
    print(
        f"[serve] {r['queries']} queries in {r['wall_s']:.2f}s "
        f"→ {r['qps']:.1f} QPS"
    )
    print(
        f"[serve] latency p50={r['p50'] * 1e3:.2f}ms "
        f"p95={r['p95'] * 1e3:.2f}ms p99={r['p99'] * 1e3:.2f}ms"
    )
    for src in ("cache", "warm", "cold"):
        if r["sources"].get(src):
            mr = r["mean_rounds_by_source"][src]
            print(
                f"[serve]   {src:5s}: {r['sources'][src]:5d} queries, "
                f"mean {mr:.1f} LP rounds"
            )
    print(
        f"[serve] batches={r['batches']} "
        f"mean_batch={r['mean_batch_size']:.1f} rejected={r['rejected']}"
    )
    print(
        f"[serve] cache: hit_rate={r['cache_hit_rate']:.2%} "
        f"evictions={r['cache_evictions']} demoted={r['cache_demoted']}"
    )
    s = art.sample
    print(
        f"[serve] sample: drug {s['entity']} top-{len(s['candidates'])} "
        f"targets {s['candidates']}"
    )
    return 0


# --------------------------------------------------------------------------
# repro_torch scenario (deprecation shim for repro_torch.launch.scenario)
# --------------------------------------------------------------------------
def scenario_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch scenario")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--list", action="store_true", help="list registered scenarios")
    mode.add_argument(
        "--info",
        metavar="NAME",
        help="generate NAME and print its statistics",
    )
    mode.add_argument(
        "--solve",
        metavar="NAME",
        help="solve NAME on one or more backends and score planted-edge "
        "recovery",
    )
    mode.add_argument(
        "--cv",
        metavar="NAME",
        help="k-fold CV against NAME's planted truth",
    )
    mode.add_argument(
        "--trace",
        metavar="NAME",
        help="generate a query trace for NAME and print its arrival "
        "statistics",
    )
    ap.add_argument(
        "--scale",
        type=float,
        default=1.0,
        help="size multiplier passed to the builder",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--backends",
        default="auto",
        help="comma-separated engine-registry keys",
    )
    ap.add_argument(
        "--devices",
        type=int,
        default=None,
        help="edge-shard count for the sharded backend",
    )
    ap.add_argument("--sigma", type=float, default=1e-4)
    ap.add_argument("--holdout-frac", type=float, default=0.1)
    ap.add_argument("--max-entities", type=int, default=32)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--process", default="poisson", help="arrival process for --trace")
    ap.add_argument("--rate-qps", type=float, default=50.0)
    ap.add_argument("--horizon-s", type=float, default=4.0)
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help="bypass the scenario disk cache",
    )
    ap.add_argument("--json", default=None, help="write the report here")
    _add_device(ap)
    return ap


def _scenario_spec(args, name: str, backend: str, section: Dict):
    """One RunSpec for a (scenario, backend) cell of the shim sweep."""
    from repro_torch.api import EvalSpec, NetworkSpec, RunSpec, SolveSpec

    return RunSpec(
        network=NetworkSpec(
            kind="scenario",
            name=name,
            scale=args.scale,
            seed=args.seed,
            cache=False if args.no_cache else None,
        ),
        solve=SolveSpec(
            sigma=args.sigma,
            seed_mode="fixed",
            backend=backend,
            devices=(args.devices if backend == "sharded" and args.devices else None),
        ),
        eval=EvalSpec(seed=args.seed, **section),
    )


def scenario_main(argv: Optional[List[str]] = None) -> int:
    _warn_deprecated(
        "the standalone scenario CLI",
        "e.g. `python -m repro_torch run --network scenario:<name> --eval recovery`",
    )
    ap = scenario_parser()
    args = ap.parse_args(argv)

    import time

    import numpy as np

    import repro_torch.scenarios as sc
    from repro_torch.api import Session

    cache = False if args.no_cache else None

    if args.list:
        rows = sc.list_rows()
        width = max(len(r["name"]) for r in rows)
        for r in rows:
            tags = f" [{','.join(r['tags'])}]" if r["tags"] else ""
            print(f"{r['name']:<{width}}  {r['description']}{tags}")
        print(f"\n{len(rows)} scenarios registered")
        report = {"scenarios": rows}
    elif args.info:
        t0 = time.time()
        bundle = sc.generate(args.info, scale=args.scale, seed=args.seed, cache=cache)
        report = bundle.describe()
        report.pop("arriving_truth", None)
        report["generate_s"] = round(time.time() - t0, 3)
        for k, v in report.items():
            print(f"{k:>20}: {v}")
    elif args.solve:
        bundle = sc.generate(args.solve, scale=args.scale, seed=args.seed, cache=cache)
        net = bundle.network
        print(
            f"[scenario] {bundle.name}: T={net.num_types} types, "
            f"{net.num_nodes} nodes, {net.num_edges} edges"
        )
        section = {
            "protocol": "recovery",
            "holdout_frac": args.holdout_frac,
            "max_entities": args.max_entities,
        }
        report = {
            "scenario": bundle.name,
            "scale": args.scale,
            "nodes": net.num_nodes,
            "edges": net.num_edges,
            "eval_pair": list(bundle.eval_pair),
            "cells": [],
        }
        F_ref, ref_name = None, None
        for key in _split_csv(args.backends):
            spec = _scenario_spec(args, args.solve, key, section)
            session = Session(spec, bundle=bundle, device=args.device)
            art = session.evaluate()
            cell = dict(art.metrics)
            cell.update(
                {
                    "backend": art.backend,
                    "requested": key,
                    "outer_iters": art.metrics["outer_iters"],
                    "seconds": round(art.seconds, 3),
                }
            )
            if F_ref is None:
                F_ref, ref_name = art.F, art.backend
            else:
                diff = float(np.max(np.abs(art.F - F_ref)))
                cell["max_abs_diff_vs_ref"] = diff
                cell["agree_ref"] = bool(diff <= AGREEMENT_TOL)
            report["cells"].append(cell)
            agree = (
                ""
                if "agree_ref" not in cell
                else f"  agree_vs_{ref_name}={cell['agree_ref']}"
            )
            print(
                f"[scenario] {art.backend:>10}: "
                f"auc={cell['recovery_auc']:.4f} "
                f"aupr={cell['recovery_aupr']:.4f} "
                f"iters={int(cell['outer_iters'])} "
                f"{art.seconds:.2f}s{agree}"
            )
    elif args.cv:
        bundle = sc.generate(args.cv, scale=args.scale, seed=args.seed, cache=cache)
        backend = _split_csv(args.backends)[0]
        spec = _scenario_spec(
            args, args.cv, backend, {"protocol": "cv", "folds": args.folds}
        )
        session = Session(spec, bundle=bundle, device=args.device)
        art = session.evaluate()
        summary = dict(art.metrics)
        summary["seconds"] = round(art.seconds, 3)
        print(
            f"[scenario] {bundle.name} {args.folds}-fold CV on planted "
            f"truth ({art.backend}): auc={summary['auc']:.4f} "
            f"aupr={summary['aupr']:.4f} "
            f"best_acc={summary['best_acc']:.4f}"
        )
        report = {
            "scenario": bundle.name,
            "backend": art.backend,
            "folds": args.folds,
            **summary,
        }
    else:
        bundle = sc.generate(args.trace, scale=args.scale, seed=args.seed, cache=cache)
        trace = sc.build_trace(
            bundle,
            args.process,
            rate_qps=args.rate_qps,
            horizon_s=args.horizon_s,
            seed=args.seed,
        )
        gaps = np.diff(trace.t) if len(trace) > 1 else np.zeros(1)
        report = {
            "scenario": bundle.name,
            "process": trace.process,
            "queries": len(trace),
            "offered_qps": round(len(trace) / trace.horizon_s, 2),
            "unique_entities": len(np.unique(trace.entity)),
            "gap_p50_ms": round(float(np.percentile(gaps, 50)) * 1e3, 3),
            "gap_p99_ms": round(float(np.percentile(gaps, 99)) * 1e3, 3),
            "deltas": len(bundle.deltas),
        }
        for k, v in report.items():
            print(f"{k:>16}: {v}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"report written to {args.json}")
    return 0


# --------------------------------------------------------------------------
# repro_torch bench (deprecation shim for benchmarks/run.py)
# --------------------------------------------------------------------------
def bench_main(argv: Optional[List[str]] = None) -> int:
    _warn_deprecated(
        "the standalone bench CLI",
        "e.g. `python -m repro_torch run --bench` or a spec with a bench section",
    )
    ap = argparse.ArgumentParser(prog="repro_torch bench")
    ap.add_argument(
        "--full",
        action="store_true",
        help="paper-scale parameters",
    )
    ap.add_argument("--only", default=None, help="comma-separated suite names")
    ap.add_argument(
        "--label",
        default=None,
        help="report label (default: ci, or full with --full)",
    )
    ap.add_argument(
        "--no-write",
        action="store_true",
        help="skip writing BENCH_torch_<label>.json / results/",
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="list registered suites and exit",
    )
    _add_device(ap)
    args, _ = ap.parse_known_args(argv)

    from repro_torch.bench.driver import import_suite_modules, run_bench

    if args.list:
        from repro_torch.bench import all_suites

        import_suite_modules()
        for s in all_suites():
            print(f"{s.name}: {s.description}")
        return 0
    try:
        outcome = run_bench(
            fast=not args.full,
            only=_split_csv(args.only),
            label=args.label,
            write=not args.no_write,
            echo=lambda line: print(line, flush=True),
            device=args.device,
        )
    except RuntimeError as e:  # CUDA asked for and missing, or a suite not ported
        print(f"bench: {e}", file=sys.stderr)
        return 2
    print(
        f"suites={len(outcome.suites)} records={outcome.records} "
        f"failures={outcome.failures}",
        file=sys.stderr,
    )
    return 1 if outcome.failures else 0


# --------------------------------------------------------------------------
# repro_torch obs
# --------------------------------------------------------------------------
def _has_telemetry(path: str) -> bool:
    """A telemetry dir is recognizable mid-stream: the consolidated
    events.jsonl only lands at the final flush, so live segments or the
    metrics snapshot also count."""
    import glob
    import os

    if not os.path.isdir(path):
        return False
    return (
        os.path.isfile(os.path.join(path, "events.jsonl"))
        or os.path.isfile(os.path.join(path, "metrics.jsonl"))
        or bool(glob.glob(os.path.join(path, "events-*.jsonl")))
    )


def _latest_run_id(results_root: str) -> Optional[str]:
    """Most recently modified results/<run_id>/ with a telemetry dir."""
    import os

    if not os.path.isdir(results_root):
        return None
    best, best_mtime = None, -1.0
    for name in os.listdir(results_root):
        tel = os.path.join(results_root, name, "telemetry")
        if _has_telemetry(tel):
            mtime = os.path.getmtime(tel)
            if mtime > best_mtime:
                best, best_mtime = name, mtime
    return best


def obs_main(argv: Optional[List[str]] = None) -> int:
    """Render (and optionally validate) a run's telemetry artifacts."""
    import os
    import time as _time

    ap = argparse.ArgumentParser(
        prog="repro_torch obs",
        description="summarize results/<run_id>/telemetry/ (DESIGN.md §14.5)",
    )
    ap.add_argument(
        "run_id",
        nargs="?",
        default=None,
        help="run id under --results-root, or a path to a run/telemetry "
        "dir; omitted = the most recent run with telemetry",
    )
    ap.add_argument("--results-root", default="results")
    ap.add_argument(
        "--validate",
        action="store_true",
        help="schema-check every telemetry line before rendering",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="print the summary digest as JSON instead of text",
    )
    ap.add_argument(
        "--follow",
        action="store_true",
        help="tail a live run: re-render the digest as flush ticks land",
    )
    ap.add_argument(
        "--interval",
        type=float,
        default=1.0,
        help="--follow poll interval in seconds (default 1.0)",
    )
    ap.add_argument(
        "--max-ticks",
        type=int,
        default=0,
        help="--follow: stop after N re-renders (0 = until interrupted)",
    )
    args = ap.parse_args(argv)

    if args.run_id is None:
        args.run_id = _latest_run_id(args.results_root)
        if args.run_id is None:
            print(
                f"repro_torch obs: no run with telemetry under "
                f"{args.results_root!r}; pass a run id or path",
                file=sys.stderr,
            )
            return 2
        print(f"[obs] defaulting to most recent run: {args.run_id}")

    candidates = [
        os.path.join(args.results_root, args.run_id, "telemetry"),
        os.path.join(args.run_id, "telemetry"),
        args.run_id,
    ]
    tel_dir = next((c for c in candidates if _has_telemetry(c)), None)
    if tel_dir is None:
        print(
            f"repro_torch obs: no telemetry found for {args.run_id!r} "
            f"(looked in {candidates}); was the run executed with "
            "obs.level != 'off'?",
            file=sys.stderr,
        )
        return 2

    from repro_torch.obs.schema import TelemetryError, validate_dir
    from repro_torch.obs.summary import load_dir, render, summarize

    if args.validate:
        try:
            counts = validate_dir(tel_dir)
        except TelemetryError as e:
            print(f"repro_torch obs: INVALID telemetry: {e}", file=sys.stderr)
            return 1
        kinds = " ".join(f"{k}:{v}" for k, v in sorted(counts.items()))
        print(f"[obs] schema ok: {kinds}")

    def emit() -> None:
        summary = summarize(*load_dir(tel_dir))
        if args.json:
            print(json.dumps(summary, indent=2, sort_keys=True))
        else:
            print(render(summary))

    if not args.follow:
        emit()
        return 0

    # live tail: re-render whenever the streamed snapshot advances
    ticks = 0
    last_sig: Any = None
    try:
        while True:
            names = sorted(
                n for n in os.listdir(tel_dir) if n.endswith((".jsonl", ".prom"))
            )
            sig = tuple(
                (n, os.path.getmtime(os.path.join(tel_dir, n))) for n in names
            )
            if sig != last_sig:
                last_sig = sig
                if ticks:
                    print(f"--- tick {ticks} ---")
                emit()
                ticks += 1
                if args.max_ticks and ticks >= args.max_ticks:
                    break
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
_SUBCOMMANDS = {
    "run": run_main,
    "obs": obs_main,
    "solve": solve_main,
    "serve": serve_main,
    "scenario": scenario_main,
    "bench": bench_main,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = " | ".join(_SUBCOMMANDS)
        print(f"usage: python -m repro_torch {{{names}}} ...\n")
        print(
            "`run` executes a declarative RunSpec (DESIGN.md §13); `obs` "
            "renders a\nrun's telemetry (§14); `solve`, `serve`, `scenario` "
            "and `bench` are\ndeprecation shims for the retired standalone CLIs."
        )
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _SUBCOMMANDS:
        print(
            f"python -m repro_torch: unknown subcommand {cmd!r} "
            f"(choose from {', '.join(_SUBCOMMANDS)})",
            file=sys.stderr,
        )
        return 2
    try:
        return _SUBCOMMANDS[cmd](rest)
    except NotImplementedError as e:
        print(f"python -m repro_torch {cmd}: {e}", file=sys.stderr)
        return 2
