"""Scenario & workload subsystem (DESIGN.md §12).

Named generators of heterogeneous-network workloads: each produces a
:class:`ScenarioBundle` — network + planted truth — behind a string-keyed
registry.  The numpy RNG streams are those of ``repro.scenarios``, so a
``(name, scale, seed)`` gives bit-identical networks in both packages.
"""

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
from repro_torch.scenarios.generators import (
    KPartiteSpec,
    PlantedKPartite,
    planted_kpartite,
    sizes_for_edges,
)

# importing the library registers the built-in scenarios
from repro_torch.scenarios import library as _library  # noqa: F401,E402

__all__ = [
    "CACHE_MIN_EDGES",
    "KPartiteSpec",
    "PlantedKPartite",
    "QueryTrace",
    "ScenarioBundle",
    "ScenarioInfo",
    "TimedDelta",
    "available_scenarios",
    "cache_dir",
    "cache_path",
    "generate",
    "get_scenario",
    "list_rows",
    "planted_kpartite",
    "register_scenario",
    "scaled_sizes",
    "sizes_for_edges",
]
