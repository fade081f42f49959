"""LP-core backend matrix: one table where kernel wins show.

Runs the same propagation problem across every backend the engine
registry knows (``repro_torch.engine``) — dense torch matmul,
blocked-CSR sparse in torch ops, and the ``kernel`` engine, whose fused
rounds launch the ``csr_round_residual`` CUDA kernel (B1) on a card — and
emits one record per cell with identical timing discipline, plus a
fixed-point agreement check against the dense engine (strict-gated: a
backend that silently diverges fails the gate even if it got faster).
The sweep iterates the registry, so registering a new backend grows the
table without touching this file.  The registry has no ``sharded``
engine yet (``ROADMAP.md`` queue A.8), so the reference's
``sharded{1,2,4}`` columns are absent and the pass says so.

Cells whose (alg, momentum) the backend does not support are skipped
LOUDLY (a ``skipped`` line, never a silent hole in the table).

Momentum cells (heavy-ball, beyond-paper) run on every
momentum-capable backend and share the momentum-off dense reference:
fixed-seed heavy ball keeps the fixed point, so ``agree_dense`` doubles
as the acceleration-correctness check (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import derived_throughput, time_callable

AGREEMENT_TOL = 5e-3
# Heavy-ball coefficient for the momentum-on cells.  The case-study
# operator's spectral radius is modest (α=0.5), so the sweet spot is small
# — 0.1 cuts rounds ~15% where 0.5 over-accelerates and doubles them.
MOMENTUM = 0.1


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One column of the matrix; ``kind`` is an engine-registry key."""

    name: str
    kind: str  # dense | sparse | kernel (| sharded, once ported)
    devices: int = 1

    def available(self, device_count: int) -> bool:
        if self.kind == "sharded":
            return device_count >= self.devices
        return True


def lp_backend_specs() -> Tuple[BackendSpec, ...]:
    """Iterate the engine registry into matrix columns, one per key (the
    reference also fans ``sharded`` out per device count, 8 on its full
    pass; this registry has no sharded engine yet)."""
    from repro_torch.engine import available_backends

    return tuple(BackendSpec(name, name) for name in available_backends())


def expand_matrix(
    backends: Sequence[BackendSpec],
    param_sets: Sequence[Dict[str, object]],
    *,
    device_count: Optional[int] = None,
) -> Tuple[List[Tuple[BackendSpec, Dict[str, object]]], List[BackendSpec]]:
    """Cross backends × params, splitting off unavailable backends.

    Returns ``(cells, skipped)`` — callers must surface ``skipped``.
    ``device_count`` defaults to the cards torch sees.
    """
    if device_count is None:
        import torch

        device_count = torch.cuda.device_count()
    runnable = [b for b in backends if b.available(device_count)]
    skipped = [b for b in backends if not b.available(device_count)]
    cells = [(b, dict(p)) for b in runnable for p in param_sets]
    return cells, skipped


def _make_solve(spec: BackendSpec, cfg, norm, Y, device) -> Callable[[], object]:
    """Bind a no-arg solve closure for one matrix cell."""
    from repro_torch.engine import make_engine

    engine = make_engine(spec.kind, cfg, device=device)
    return lambda: engine.run(norm, seeds=Y)


def _cell_skip_reason(spec: BackendSpec, alg: str, momentum: float):
    """Why a (backend, params) cell cannot run, or None."""
    from repro_torch.engine import get_backend_class

    cls = get_backend_class(spec.kind)
    if alg not in cls.supports_algs:
        return f"no {alg} path for backend {spec.name}"
    if momentum and not cls.supports_momentum:
        return f"backend {spec.name} has no momentum loop"
    return None


def lp_matrix_records(fast: bool = True, device=None) -> List[BenchRecord]:
    """The ``lp_matrix`` suite: every registered backend, same network."""
    from repro_torch.core.solver import HeteroLP, LPConfig
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet

    if fast:
        # sub-ms cells on a shared runner: more repeats per cell so the
        # median sits below the scheduler-noise tail (the compare gate
        # diffs medians)
        spec_net = DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6)
        n_seeds, repeats = 16, 5
        algs = ("dhlp2",)
    else:
        spec_net = DrugNetSpec(n_drug=96, n_disease=64, n_target=48, n_clusters=8)
        n_seeds, repeats = 64, 3
        algs = ("dhlp1", "dhlp2")

    dn = make_drugnet(spec_net)
    norm = dn.network.normalize()
    n = norm.num_nodes
    edges = dn.network.num_edges
    Y = np.eye(n, dtype=np.float32)[:, :n_seeds]

    # momentum on/off × alg; momentum only accelerates the fused DHLP-2
    # round, so the on-cells pair with dhlp2
    param_sets: List[Dict[str, object]] = [{"alg": a, "momentum": 0.0} for a in algs]
    if "dhlp2" in algs:
        param_sets.append({"alg": "dhlp2", "momentum": MOMENTUM})
    # no registered backend needs more than one card, so none is skipped
    # for want of devices; the reference's sharded columns wait for A.8
    cells, _ = expand_matrix(lp_backend_specs(), param_sets)
    records: List[BenchRecord] = []
    print(
        "lp_matrix: skipped backends sharded1, sharded2, sharded4: "
        "not ported (ROADMAP A.8)",
        flush=True,
    )

    # dense reference fixed points, one per alg (fixed-seed mode: every
    # backend AND the momentum cells must land on the same answer)
    reference: Dict[str, np.ndarray] = {}
    for alg in algs:
        cfg = LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed")
        reference[alg] = HeteroLP(cfg, device=device).run(norm, seeds=Y).F

    for spec, params in cells:
        alg = str(params["alg"])
        momentum = float(params["momentum"])
        reason = _cell_skip_reason(spec, alg, momentum)
        mom_tag = "_mom" if momentum else ""
        name = f"{alg}{mom_tag}_{spec.name}"
        if reason is not None:
            print(f"lp_matrix: skipped {name} ({reason})", flush=True)
            continue
        cfg = LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed", momentum=momentum)
        solve = _make_solve(spec, cfg, norm, Y, device)
        res = solve()  # warmup: plan build + kernel load + first run
        stats = time_callable(solve, warmup=0, repeats=repeats)
        diff = float(np.max(np.abs(res.F - reference[alg])))
        derived = derived_throughput(stats, edges=edges, supersteps=res.supersteps)
        derived.update(
            {
                "outer_iters": float(res.outer_iters),
                "supersteps": float(res.supersteps),
                "agree_dense": 1.0 if diff <= AGREEMENT_TOL else 0.0,
                "max_abs_diff_vs_dense": diff,
            }
        )
        records.append(
            BenchRecord(
                suite="lp_matrix",
                name=name,
                backend=spec.name,
                params={
                    "alg": alg,
                    "momentum": momentum,
                    "nodes": n,
                    "edges": int(edges),
                    "seeds": n_seeds,
                    "sigma": 1e-4,
                    "devices": spec.devices,
                },
                stats=stats.to_dict(),
                derived=derived,
                strict=["outer_iters", "supersteps", "agree_dense"],
            )
        )
    return records


# --------------------------------------------------------------------------
# Scenario × backend cross (DESIGN.md §12.4)
# --------------------------------------------------------------------------
# Each cell solves one scenario's planted-edge recovery problem on one
# registry backend: wall time plus three strict correctness metrics —
# recovery AUC against the planted truth, fixed-point agreement vs the
# cell row's reference backend, and the iteration count.  The fast pass
# covers small instances of the non-bio scenarios (the gate's coverage);
# the full pass adds the nominal-scale cells including the >=1M-edge
# powerlaw row.


def _scenario_rows(fast: bool):
    """(scenario, scale, backends) rows; backends[0] is the agreement
    reference — dense where the (N, N) operator is feasible, blocked-CSR
    sparse on the million-edge row."""
    if fast:
        return (
            ("bipartite", 0.35, ("dense", "sparse")),
            ("kpartite5", 0.35, ("dense", "sparse")),
            ("kpartite_heterophilic", 0.35, ("dense", "sparse")),
            ("powerlaw", 0.02, ("dense", "sparse")),
        )
    return (
        ("bipartite", 1.0, ("dense", "sparse")),
        ("kpartite5", 1.0, ("dense", "sparse", "kernel")),
        ("kpartite_heterophilic", 1.0, ("dense", "sparse", "kernel")),
        ("powerlaw", 1.0, ("sparse",)),
        ("streaming", 1.0, ("dense", "sparse")),
    )


def scenario_matrix_records(fast: bool = True, device=None) -> List[BenchRecord]:
    """The ``scenario_matrix`` suite: named workloads × registry backends.

    Each cell is one RunSpec resolved by a Session (DESIGN.md §13) on
    ``device`` — the bundle is generated once per row (disk-cached at
    heavyweight sizes) and injected, the backend resolves through the
    session, and the timed closure runs the session's eval engine so
    prepare() caching matches what ``python -m repro_torch run`` would do.
    """
    import repro_torch.scenarios as sc
    from repro_torch.api import EvalSpec, NetworkSpec, RunSpec, Session, SolveSpec

    max_entities = 16 if fast else 24
    repeats = 3
    records: List[BenchRecord] = []
    for scenario, scale, backends in _scenario_rows(fast):
        net_spec = NetworkSpec(kind="scenario", name=scenario, scale=scale, seed=0)
        bundle = sc.generate(scenario, scale=scale, seed=0)
        net = bundle.network
        problem = sc.make_recovery_problem(
            bundle, holdout_frac=0.1, max_entities=max_entities, seed=0
        )
        edges = net.num_edges
        F_ref = None
        for backend in backends:
            session = Session(
                RunSpec(
                    network=net_spec,
                    solve=SolveSpec(sigma=1e-4, seed_mode="fixed", backend=backend),
                    eval=EvalSpec(max_entities=max_entities),
                ),
                bundle=bundle,
                device=device,
            )
            engine = session.eval_engine

            def solve(engine=engine):
                return engine.run(problem.masked_net, seeds=problem.Y)

            res = solve()  # warmup: plan build + kernel load + first run
            stats = time_callable(solve, warmup=0, repeats=repeats)
            derived = derived_throughput(
                stats, edges=edges, supersteps=res.supersteps
            )
            derived.update(problem.metrics(res.F))
            derived["outer_iters"] = float(res.outer_iters)
            if F_ref is None:
                F_ref = res.F
                derived["agree_ref"] = 1.0  # the reference itself
            else:
                diff = float(np.max(np.abs(res.F - F_ref)))
                derived["agree_ref"] = (
                    1.0 if diff <= AGREEMENT_TOL else 0.0
                )
                derived["max_abs_diff_vs_ref"] = diff
            records.append(
                BenchRecord(
                    suite="scenario_matrix",
                    name=f"{scenario}_{backend}",
                    backend=backend,
                    params={
                        "scenario": scenario,
                        "scale": scale,
                        "types": net.num_types,
                        "nodes": net.num_nodes,
                        "edges": int(edges),
                        "seeds": int(problem.Y.shape[1]),
                        "reference": backends[0],
                        "sigma": 1e-4,
                    },
                    stats=stats.to_dict(),
                    derived=derived,
                    strict=["outer_iters", "agree_ref", "recovery_auc"],
                )
            )
    return records


def register() -> None:
    """Register the matrix suites (kept out of module import, so that
    importing ``AGREEMENT_TOL`` registers nothing)."""
    from repro_torch.bench.registry import register_suite

    register_suite(
        "lp_matrix",
        description="LP core across every engine-registry backend",
    )(lp_matrix_records)
    register_suite(
        "scenario_matrix",
        description="scenario registry × engine backends with planted-"
        "truth recovery",
    )(scenario_matrix_records)
