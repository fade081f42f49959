"""The registered scenario library (DESIGN.md §12.2).

Five scenarios spanning the diversity/scale axes the paper's
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
                     Tables 5/6 territory).

The ``streaming`` scenarios need the arrival-process module and are not
part of this package yet.  Every generator draws the same numpy RNG
streams as its namesake in ``repro.scenarios.library``, so both packages
build bit-identical networks from one ``(scale, seed)``.

Every builder takes ``(scale, seed, **kw)`` and returns a
:class:`~repro_torch.scenarios.base.ScenarioBundle`; sizes floor at small
values so ``scale=0.1`` stays a valid smoke test.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.network import TypePair
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
