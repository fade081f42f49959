"""Scenario & workload subsystem (DESIGN.md §12).

Named generators of heterogeneous-network workloads: each produces a
:class:`ScenarioBundle` — network + planted truth + optional delta
stream + optional serve query trace — behind a string-keyed registry,
so eval, serving, and the ``repro_torch scenario`` CLI all name workloads
the same way the engine registry names backends.  The numpy RNG streams
are those of ``repro.scenarios``, so a ``(name, scale, seed)`` gives
bit-identical bundles in both packages.
"""
from repro_torch.scenarios.arrivals import (
    ARRIVAL_PROCESSES,
    arrival_times,
    build_trace,
    zipf_entities,
)
from repro_torch.scenarios.base import (
    CACHE_MIN_EDGES,
    QueryTrace,
    ScenarioBundle,
    ScenarioInfo,
    TimedDelta,
    available_scenarios,
    cache_dir,
    cache_path,
    generate,
    get_scenario,
    list_rows,
    register_scenario,
    scaled_sizes,
)
from repro_torch.scenarios.evaluate import (
    RecoveryProblem,
    backend_solver_fn,
    default_lp_config,
    make_recovery_problem,
    recovery_auc,
    scenario_cross_validate,
    solve_recovery,
)
from repro_torch.scenarios.generators import (
    KPartiteSpec,
    PlantedKPartite,
    planted_kpartite,
    sizes_for_edges,
)

# importing the library registers the built-in scenarios
from repro_torch.scenarios import library as _library  # noqa: F401,E402

__all__ = [
    "ARRIVAL_PROCESSES",
    "CACHE_MIN_EDGES",
    "KPartiteSpec",
    "PlantedKPartite",
    "QueryTrace",
    "RecoveryProblem",
    "ScenarioBundle",
    "ScenarioInfo",
    "TimedDelta",
    "arrival_times",
    "available_scenarios",
    "backend_solver_fn",
    "build_trace",
    "cache_dir",
    "cache_path",
    "default_lp_config",
    "generate",
    "get_scenario",
    "list_rows",
    "make_recovery_problem",
    "planted_kpartite",
    "recovery_auc",
    "register_scenario",
    "scaled_sizes",
    "scenario_cross_validate",
    "sizes_for_edges",
    "solve_recovery",
    "zipf_entities",
]
