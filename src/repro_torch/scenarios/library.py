"""The registered scenario library (DESIGN.md §12.2).

Five-plus scenarios spanning the diversity/scale axes the paper's
"general methods for heterogeneous networks" claim implies but its
experiments never stress:

* ``bio_tri``      — the tri-partite drug/disease/target case study
                     (adapter over the shared k-partite generator;
                     ``data/drugnet.py`` keeps its legacy API on top of
                     the same construction);
* ``kpartite5``    — a 5-type mechanism network on a non-complete pair
                     schema (drug–disease–target–gene–side-effect);
* ``kpartite_heterophilic`` — planted CROSS-cluster associations over a
                     4-type complete schema: similarity stays
                     homophilic, associations follow a fixed-point-free
                     cluster shift (Deng et al., PAPERS.md);
* ``powerlaw``     — heavy-tailed degrees from Pareto propensities with
                     a ``scale`` knob calibrated in expected edges
                     (nominal scale=1.0 ⇒ ≥1M edges, the paper's
                     Tables 5/6 territory);
* ``streaming``    — a tri-partite net whose planted edges are partly
                     held out at t=0 and re-added by a timed GraphDelta
                     stream, plus a diurnal query trace: the serve
                     layer's incremental-update workload with ground
                     truth attached.

Every generator draws the same numpy RNG streams as its namesake in
``repro.scenarios.library``, so both packages build bit-identical
networks, delta streams and traces from one ``(scale, seed)``.

Every builder takes ``(scale, seed, **kw)`` and returns a
:class:`~repro_torch.scenarios.base.ScenarioBundle`; sizes floor at small
values so ``scale=0.1`` stays a valid smoke test.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.network import GraphDelta, HeteroNetwork, TypePair
from repro_torch.scenarios.arrivals import build_trace
from repro_torch.scenarios.base import (
    QueryTrace,
    ScenarioBundle,
    TimedDelta,
    register_scenario,
    scaled_sizes,
)
from repro_torch.scenarios.generators import (
    KPartiteSpec,
    PlantedKPartite,
    planted_kpartite,
    sizes_for_edges,
)

# Empirical calibration of expected-vs-realized edges for the powerlaw
# construction (propensity clipping + symmetrized similarity support make
# the analytic count an underestimate); keeps nominal scale=1.0 >= 1M.
_POWERLAW_EDGE_TARGET = 1_700_000


def _bundle_from_planted(
    name: str,
    pk: PlantedKPartite,
    eval_pair: TypePair,
    *,
    deltas: Tuple[TimedDelta, ...] = (),
    trace: Optional[QueryTrace] = None,
    meta: Optional[dict] = None,
) -> ScenarioBundle:
    return ScenarioBundle(
        name=name,
        network=pk.network,
        truth=pk.truth,
        eval_pair=eval_pair,
        clusters=pk.clusters,
        deltas=deltas,
        trace=trace,
        meta={"spec_seed": pk.spec.seed, **(meta or {})},
    )


@register_scenario(
    "bio_tri",
    description="tri-partite drug/disease/target case study (paper shape)",
    tags=("bio", "homophilic"),
)
def bio_tri(scale: float = 1.0, seed: int = 0, **kw) -> ScenarioBundle:
    spec = KPartiteSpec(
        sizes=scaled_sizes((223, 150, 95), scale),
        n_clusters=12,
        type_names=("drug", "disease", "target"),
        seed=seed,
        **kw,
    )
    return _bundle_from_planted("bio_tri", planted_kpartite(spec), (0, 2))


@register_scenario(
    "bipartite",
    description="2-type net, one association pair (smallest schema)",
    tags=("bipartite", "homophilic"),
)
def bipartite(scale: float = 1.0, seed: int = 0, **kw) -> ScenarioBundle:
    """The minimal heterogeneous schema the generators support: two node
    types joined by a single association block — e.g. plain drug–target
    prediction with per-type similarity but no third information source.
    Exercises the T=2 edge of every protocol (hetero_scale = 1/(T−1) = 1,
    the strictly-literal paper update)."""
    spec = KPartiteSpec(
        sizes=scaled_sizes((160, 110), scale),
        pairs=((0, 1),),
        n_clusters=8,
        type_names=("drug", "target"),
        seed=seed,
        **kw,
    )
    return _bundle_from_planted("bipartite", planted_kpartite(spec), (0, 1))


@register_scenario(
    "kpartite5",
    description="5-type mechanism net on a non-complete pair schema",
    tags=("kpartite", "homophilic"),
)
def kpartite5(scale: float = 1.0, seed: int = 0, **kw) -> ScenarioBundle:
    spec = KPartiteSpec(
        sizes=scaled_sizes((120, 90, 80, 70, 60), scale),
        pairs=((0, 1), (0, 2), (1, 2), (2, 3), (0, 4), (3, 4)),
        n_clusters=8,
        type_names=("drug", "disease", "target", "gene", "side_effect"),
        seed=seed,
        **kw,
    )
    return _bundle_from_planted("kpartite5", planted_kpartite(spec), (2, 3))


@register_scenario(
    "kpartite_heterophilic",
    description="4-type net with planted cross-cluster associations",
    tags=("kpartite", "heterophilic"),
)
def kpartite_heterophilic(
    scale: float = 1.0, seed: int = 0, **kw
) -> ScenarioBundle:
    spec = KPartiteSpec(
        sizes=scaled_sizes((100, 80, 70, 60), scale),
        n_clusters=6,
        heterophily=True,
        type_names=("a", "b", "c", "d"),
        seed=seed,
        **kw,
    )
    return _bundle_from_planted(
        "kpartite_heterophilic", planted_kpartite(spec), (0, 2)
    )


@register_scenario(
    "powerlaw",
    description="heavy-tailed-degree net; scale=1.0 targets >=1M edges",
    tags=("powerlaw", "scale"),
)
def powerlaw(scale: float = 1.0, seed: int = 0, **kw) -> ScenarioBundle:
    target = max(2000, int(_POWERLAW_EDGE_TARGET * scale))
    base = KPartiteSpec(
        sizes=(223, 150, 95),  # ratio only; resized to the edge target
        n_clusters=12,
        degree="powerlaw",
        sim_density=0.35,
        sim_cross_frac=0.08,
        dense_sim_noise=False,
        type_names=("drug", "disease", "target"),
        seed=seed,
        **kw,
    )
    import dataclasses as _dc

    spec = _dc.replace(base, sizes=sizes_for_edges(base, target))
    pk = planted_kpartite(spec)
    return _bundle_from_planted(
        "powerlaw",
        pk,
        (0, 2),
        meta={"target_edges": target, "edges": pk.network.num_edges},
    )


def _streaming_deltas(
    rng: np.random.Generator,
    heldout: np.ndarray,
    pair: TypePair,
    horizon_s: float,
    n_batches: int,
    add_nodes_type: Optional[int],
) -> Tuple[TimedDelta, ...]:
    """Timed delta stream re-adding the held-out planted edges."""
    entries = np.argwhere(heldout)
    rng.shuffle(entries)
    batches = np.array_split(entries, max(1, n_batches))
    out = []
    # deltas land strictly inside the horizon so a trace replay sees them
    times = np.linspace(0.15, 0.85, len(batches)) * horizon_s
    for b, (t, batch) in enumerate(zip(times, batches)):
        assoc = tuple(
            (pair, int(u), int(v), 1.0) for u, v in np.asarray(batch)
        )
        add = (
            {add_nodes_type: 2}
            if (add_nodes_type is not None and b == len(batches) // 2)
            else {}
        )
        out.append(
            TimedDelta(t=float(t), delta=GraphDelta(assoc=assoc, add_nodes=add))
        )
    return tuple(out)


@register_scenario(
    "streaming",
    description="delta stream re-adds held-out edges under a diurnal trace",
    tags=("streaming", "serve"),
)
def streaming(
    scale: float = 1.0,
    seed: int = 0,
    *,
    holdout_frac: float = 0.2,
    n_deltas: int = 8,
    rate_qps: float = 40.0,
    horizon_s: float = 4.0,
    trace_process: str = "diurnal",
    **kw,
) -> ScenarioBundle:
    spec = KPartiteSpec(
        sizes=scaled_sizes((60, 45, 30), scale),
        n_clusters=6,
        type_names=("drug", "disease", "target"),
        seed=seed,
        **kw,
    )
    pk = planted_kpartite(spec)
    pair: TypePair = (0, 2)
    rng = np.random.default_rng(seed + 1)
    planted = pk.truth[pair]
    pos = np.argwhere(planted)
    n_hold = max(1, int(len(pos) * holdout_frac))
    sel = pos[rng.choice(len(pos), size=n_hold, replace=False)]
    heldout = np.zeros_like(planted)
    heldout[sel[:, 0], sel[:, 1]] = True

    # t=0 network starts WITHOUT the held-out edges; truth matches it so
    # the CV/recovery protocols stay well-posed against the initial graph
    net0 = pk.network.with_masked_fold(pair, heldout)
    truth0 = dict(pk.truth)
    truth0[pair] = planted & ~heldout
    pk0 = PlantedKPartite(
        network=net0, clusters=pk.clusters, truth=truth0, spec=spec
    )
    deltas = _streaming_deltas(
        rng, heldout, pair, horizon_s, n_deltas, add_nodes_type=0
    )
    bundle = _bundle_from_planted(
        "streaming",
        pk0,
        pair,
        deltas=deltas,
        meta={
            "heldout_edges": int(n_hold),
            "holdout_frac": holdout_frac,
            "arriving_truth": heldout,
        },
    )
    bundle.trace = build_trace(
        bundle,
        trace_process,
        rate_qps=rate_qps,
        horizon_s=horizon_s,
        seed=seed,
    )
    return bundle


@register_scenario(
    "streaming_chaos",
    description="streaming under fault drills: denser delta churn plus a "
    "suggested kill plan for the ft injectors",
    tags=("streaming", "serve", "chaos"),
)
def streaming_chaos(
    scale: float = 1.0,
    seed: int = 0,
    *,
    n_deltas: int = 12,
    rate_qps: float = 60.0,
    horizon_s: float = 3.0,
    **kw,
) -> ScenarioBundle:
    """The chaos-drill workload (DESIGN.md §16.4).

    Same planted net + held-out delta stream as ``streaming``, but with
    more delta batches (every version bump churns the serve cache a
    guarded replay must survive) and a ``fault_plan`` in ``meta`` — the
    kill points the chaos specs feed into ``ft.inject_solve_fault`` /
    ``ft.inject_serve_fault``.  Injection stays spec-driven: the scenario
    only documents where a kill exercises the most recovery machinery
    (mid-solve after the first checkpoint; a serve batch after the first
    cache snapshot).
    """
    bundle = streaming(
        scale,
        seed,
        n_deltas=n_deltas,
        rate_qps=rate_qps,
        horizon_s=horizon_s,
        **kw,
    )
    bundle.name = "streaming_chaos"
    bundle.meta = {
        **bundle.meta,
        "fault_plan": {"solve_step": 3, "serve_attempt": 2},
    }
    return bundle
