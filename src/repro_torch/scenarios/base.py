"""Scenario registry: named workloads = network + truth + deltas + trace.

A *scenario* is everything one experiment needs, bundled:

* a :class:`~repro_torch.core.network.HeteroNetwork` with an arbitrary
  type-count schema,
* the planted ground-truth positives per association pair (what CV and
  recovery protocols score against),
* optionally a timed :class:`~repro_torch.core.network.GraphDelta` stream (the
  serve layer's incremental-update workload), and
* optionally a serve query trace with a configurable arrival process
  (``repro_torch.scenarios.arrivals``).

Builders register under a string key with
``@register_scenario("name", description=...)`` and have signature
``fn(scale: float, seed: int, **kw) -> ScenarioBundle``; ``scale``
multiplies the scenario's nominal size (node counts or target edges) so
one registration serves both a small test (``scale << 1``) and the
full-scale cell.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import GraphDelta, HeteroNetwork, TypePair


@dataclasses.dataclass(frozen=True)
class TimedDelta:
    """A graph edit scheduled at ``t`` seconds into the workload."""

    t: float
    delta: GraphDelta


@dataclasses.dataclass(frozen=True)
class QueryTrace:
    """A serve workload: arrival-stamped ranking queries.

    Columns are parallel arrays (event *i* = ``(t[i], entity[i],
    target_type[i])``); ``t`` is seconds from trace start,
    non-decreasing.  ``process`` names the arrival process that generated
    the timestamps (poisson | bursty | diurnal).
    """

    t: np.ndarray            # (Q,) float64, sorted
    entity: np.ndarray       # (Q,) int32 global node ids
    target_type: np.ndarray  # (Q,) int32
    process: str
    rate_qps: float
    horizon_s: float

    def __len__(self) -> int:
        return int(self.t.shape[0])


@dataclasses.dataclass
class ScenarioBundle:
    """One generated scenario instance (see module docstring)."""

    name: str
    network: HeteroNetwork
    #: planted positives per pair — boolean arrays shaped like ``R[pair]``
    truth: Dict[TypePair, np.ndarray]
    #: the pair recovery/CV protocols score by default
    eval_pair: TypePair
    clusters: Optional[Tuple[np.ndarray, ...]] = None
    deltas: Tuple[TimedDelta, ...] = ()
    trace: Optional[QueryTrace] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        i, j = self.eval_pair
        if (i, j) not in self.network.R:
            raise ValueError(f"eval_pair {(i, j)} has no association block")
        for pair, mask in self.truth.items():
            if mask.shape != self.network.R[pair].shape:
                raise ValueError(
                    f"truth[{pair}] shape {mask.shape} != "
                    f"{self.network.R[pair].shape}"
                )

    def describe(self) -> Dict[str, Any]:
        net = self.network
        return {
            "name": self.name,
            "types": net.num_types,
            "type_names": list(net.type_names or ()),
            "sizes": list(net.sizes),
            "nodes": net.num_nodes,
            "edges": net.num_edges,
            "pairs": sorted(net.R),
            "eval_pair": tuple(self.eval_pair),
            "planted_positives": {
                str(k): int(v.sum()) for k, v in sorted(self.truth.items())
            },
            "deltas": len(self.deltas),
            "trace": None
            if self.trace is None
            else {
                "process": self.trace.process,
                "queries": len(self.trace),
                "rate_qps": self.trace.rate_qps,
                "horizon_s": self.trace.horizon_s,
            },
            **self.meta,
        }


ScenarioFn = Callable[..., ScenarioBundle]


@dataclasses.dataclass(frozen=True)
class ScenarioInfo:
    name: str
    fn: ScenarioFn
    description: str = ""
    tags: Tuple[str, ...] = ()


_REGISTRY: Dict[str, ScenarioInfo] = {}


def register_scenario(
    name: str, *, description: str = "", tags: Tuple[str, ...] = ()
) -> Callable[[ScenarioFn], ScenarioFn]:
    """Decorator: register a builder ``fn(scale, seed, **kw)`` by name."""

    def deco(fn: ScenarioFn) -> ScenarioFn:
        existing = _REGISTRY.get(name)
        if existing is not None and existing.fn is not fn:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = ScenarioInfo(
            name=name, fn=fn, description=description, tags=tags
        )
        return fn

    return deco


def available_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_scenario(name: str) -> ScenarioInfo:
    if name not in _REGISTRY:
        known = ", ".join(available_scenarios()) or "<none>"
        raise KeyError(f"unknown scenario {name!r}; registered: {known}")
    return _REGISTRY[name]


# --------------------------------------------------------------------------
# Generation + disk cache
# --------------------------------------------------------------------------
# Heavyweight bundles (the 1.2M-edge powerlaw cell) are pickled once per
# machine under results/scenario_cache_torch/ and reloaded on repeat
# generation.
# Small bundles are not worth the disk churn — only networks at or
# above this edge count are written.
CACHE_MIN_EDGES = 200_000
# bump when generator semantics change: stale cache entries must miss.
# The salt also keeps this package's pickles apart from ``repro``'s: a
# bundle pickled by ``repro`` would import ``repro`` (and JAX) on load.
_CACHE_SALT = "torch-v1"


def cache_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_SCENARIO_CACHE_DIR",
        os.path.join("results", "scenario_cache_torch"),
    )


def _cache_key(name: str, scale: float, seed: int, kw: Dict[str, Any]) -> str:
    """Digest of scenario name + every builder parameter (+ salt)."""
    parts = [
        _CACHE_SALT,
        name,
        repr(float(scale)),
        repr(int(seed)),
        repr(sorted(kw.items())),
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def cache_path(name: str, scale: float, seed: int, kw: Dict[str, Any]) -> str:
    return os.path.join(cache_dir(), f"{name}-{_cache_key(name, scale, seed, kw)}.pkl")


def _cache_enabled() -> bool:
    return os.environ.get("REPRO_SCENARIO_CACHE", "1") != "0"


def generate(
    name: str,
    *,
    scale: float = 1.0,
    seed: int = 0,
    cache: Optional[bool] = None,
    **kw,
) -> ScenarioBundle:
    """Instantiate a registered scenario at ``scale``.

    ``cache=None`` applies the policy: reuse/write the per-machine disk
    cache (keyed by scenario name + params + seed) for bundles with at
    least :data:`CACHE_MIN_EDGES` edges, unless ``REPRO_SCENARIO_CACHE=0``.
    ``cache=False`` bypasses it entirely (the CLIs' ``--no-cache``);
    ``cache=True`` forces a write regardless of size.
    """
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    use_cache = _cache_enabled() if cache is None else cache
    path = cache_path(name, scale, seed, kw) if use_cache else None
    if path is not None and os.path.exists(path):
        try:
            with open(path, "rb") as f:
                bundle = pickle.load(f)
            if isinstance(bundle, ScenarioBundle) and bundle.name == name:
                return bundle
        except Exception:
            # a torn/stale entry must never break generation — fall through
            pass
    bundle = get_scenario(name).fn(scale=scale, seed=seed, **kw)
    if path is not None and (
        cache is True or bundle.network.num_edges >= CACHE_MIN_EDGES
    ):
        _atomic_pickle(bundle, path)
    return bundle


def _atomic_pickle(bundle: ScenarioBundle, path: str) -> None:
    """Write-then-rename so concurrent generators never read a torn file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(bundle, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def scaled_sizes(
    base: Tuple[int, ...], scale: float, floor: int = 8
) -> Tuple[int, ...]:
    """Multiply nominal per-type sizes by ``scale`` with a sanity floor."""
    return tuple(max(floor, int(round(n * scale))) for n in base)


def list_rows() -> List[Dict[str, Any]]:
    """Registry summary rows for the CLI's ``--list``."""
    return [
        {
            "name": info.name,
            "description": info.description,
            "tags": list(info.tags),
        }
        for info in (_REGISTRY[k] for k in available_scenarios())
    ]
