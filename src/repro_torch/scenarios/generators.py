"""The k-partite planted-structure generator — the repo's ONE generator idiom.

Every heterogeneous network the repo synthesizes (the tri-partite
drug–disease–target case study included — ``data/drugnet.py`` is now an
adapter over this module) comes from the same construction:

* latent *mechanism* clusters shared by all T node types;
* per-type similarity = intra-cluster affinity (+ optional noise floor);
* per-pair associations = Bernoulli draws, dense where the pair's
  cluster-match relation holds and rare noise elsewhere.

Because associations are *planted*, the generator returns the exact
positive set (``truth``) alongside the network, so CV / recovery
protocols evaluate against ground truth known by construction — the
same idea as the paper's Table 2, generalized to arbitrary type counts.

Two axes beyond the homophilic tri-partite case study
(PAPERS.md: Deng et al., *LP on K-partite Graphs with Heterophily*):

* **heterophily** — the planted relation maps cluster ``c`` of type i to
  cluster ``sigma(c) != c`` of type j (a fixed-point-free shift), so
  associations are CROSS-cluster while similarities stay intra-cluster;
* **power-law degrees** — per-node Pareto propensities multiply the edge
  probabilities (similarity support included), producing hubs and a
  heavy-tailed degree distribution at controlled expected edge counts.

RNG discipline: draws happen in a fixed order (clusters per type, then
similarities per type, then associations per sorted pair) so the
tri-partite default reproduces ``data/drugnet.py``'s historical streams
bit-for-bit; optional axes only draw when enabled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import HeteroNetwork, TypePair


@dataclasses.dataclass(frozen=True)
class KPartiteSpec:
    """Parameters of one planted k-partite network.

    ``pairs=()`` means every ``i < j`` pair carries an association block
    (complete type graph); pass an explicit schema for sparser ones.
    """

    sizes: Tuple[int, ...]
    pairs: Tuple[TypePair, ...] = ()
    n_clusters: int = 12
    # probability of an association where the planted relation holds /
    # noise probability elsewhere
    p_intra: float = 0.9
    p_noise: float = 0.0005
    # similarity strengths
    sim_intra: float = 0.8
    sim_noise: float = 0.02
    # heterophily: plant associations across a cluster shift, not the
    # diagonal (similarities stay homophilic)
    heterophily: bool = False
    # degree model: "uniform" or "powerlaw" (Pareto propensities)
    degree: str = "uniform"
    powerlaw_exponent: float = 2.0
    # powerlaw mode only: keep-probability scale of intra-cluster
    # similarity support (1.0 ~ dense blocks), the cross-cluster fraction
    # of that scale (lets hub degrees escape the cluster-size ceiling —
    # the heavy tail is unbounded in n, not capped at n/k), and whether
    # the similarity noise floor is dense (the drugnet convention) or
    # planted-only
    sim_density: float = 1.0
    sim_cross_frac: float = 0.0
    dense_sim_noise: bool = True
    type_names: Optional[Tuple[str, ...]] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if len(self.sizes) < 2:
            raise ValueError("need at least two node types")
        if self.degree not in ("uniform", "powerlaw"):
            raise ValueError(f"unknown degree model {self.degree!r}")
        for i, j in self.resolved_pairs():
            if not (0 <= i < len(self.sizes) and 0 <= j < len(self.sizes)):
                raise ValueError(f"pair {(i, j)} out of range")
            if i >= j:
                raise ValueError(f"pairs must be canonical i < j, got {(i, j)}")

    def resolved_pairs(self) -> Tuple[TypePair, ...]:
        if self.pairs:
            return tuple(self.pairs)
        t = len(self.sizes)
        return tuple((i, j) for i in range(t) for j in range(i + 1, t))


@dataclasses.dataclass
class PlantedKPartite:
    """Generator output: the network plus its construction ground truth."""

    network: HeteroNetwork
    clusters: Tuple[np.ndarray, ...]
    #: boolean per-pair masks of PLANTED positives (noise edges excluded)
    truth: Dict[TypePair, np.ndarray]
    spec: KPartiteSpec


def _pair_shift(spec: KPartiteSpec, pair_index: int) -> int:
    """Fixed-point-free cluster shift for heterophilic pair #``pair_index``."""
    k = spec.n_clusters
    if k < 2:
        raise ValueError("heterophily needs n_clusters >= 2")
    return 1 + pair_index % (k - 1)


def _similarity(
    rng: np.random.Generator,
    clusters: np.ndarray,
    spec: KPartiteSpec,
    theta: Optional[np.ndarray],
) -> np.ndarray:
    n = clusters.shape[0]
    same = clusters[:, None] == clusters[None, :]
    if theta is None:
        base = np.where(same, spec.sim_intra, 0.0)
        noise = rng.random((n, n)) * spec.sim_noise
        sim = base + noise
    else:
        # power-law support: a similarity slot survives with probability
        # ~ theta_u * theta_v (hubs keep more neighbors); cross-cluster
        # slots at a `sim_cross_frac` discount so hub degrees are not
        # capped at the cluster size
        scale = np.where(
            same,
            spec.sim_density,
            spec.sim_density * spec.sim_cross_frac,
        )
        keep_p = np.minimum(1.0, scale * np.outer(theta, theta))
        keep = rng.random((n, n)) < keep_p
        sim = np.where(keep, spec.sim_intra, 0.0)
        if spec.dense_sim_noise:
            sim = sim + rng.random((n, n)) * spec.sim_noise
        else:
            sim = sim + keep * (rng.random((n, n)) * spec.sim_noise)
    sim = (sim + sim.T) / 2.0
    np.fill_diagonal(sim, 1.0)
    return sim


def _association(
    rng: np.random.Generator,
    ca: np.ndarray,
    cb: np.ndarray,
    spec: KPartiteSpec,
    pair_index: int,
    theta_a: Optional[np.ndarray],
    theta_b: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one association block; returns ``(R, planted_mask)``."""
    if spec.heterophily:
        shift = _pair_shift(spec, pair_index)
        match = ((ca[:, None] + shift) % spec.n_clusters) == cb[None, :]
    else:
        match = ca[:, None] == cb[None, :]
    p = np.where(match, spec.p_intra, spec.p_noise)
    if theta_a is not None:
        p = np.minimum(1.0, p * np.outer(theta_a, theta_b))
    edges = rng.random((ca.shape[0], cb.shape[0])) < p
    return edges.astype(np.float64), edges & match


def planted_kpartite(spec: KPartiteSpec) -> PlantedKPartite:
    """Generate the network + planted truth for ``spec``.

    Draw order (clusters, similarities, associations over sorted pairs)
    is part of the contract: the tri-partite uniform default reproduces
    the historical ``make_drugnet`` streams exactly.
    """
    rng = np.random.default_rng(spec.seed)
    clusters = tuple(
        rng.integers(0, spec.n_clusters, size=n).astype(np.int32)
        for n in spec.sizes
    )
    thetas: List[Optional[np.ndarray]]
    if spec.degree == "powerlaw":
        # mean-1 Pareto propensities (drawn only on this path so the
        # uniform path's RNG stream is untouched)
        a = spec.powerlaw_exponent
        thetas = []
        for n in spec.sizes:
            t = 1.0 + rng.pareto(a, size=n)
            thetas.append(t * (a - 1.0) / a if a > 1.0 else t)
    else:
        thetas = [None] * len(spec.sizes)
    P = [_similarity(rng, c, spec, th) for c, th in zip(clusters, thetas)]
    pairs = spec.resolved_pairs()
    R: Dict[TypePair, np.ndarray] = {}
    truth: Dict[TypePair, np.ndarray] = {}
    for idx, (i, j) in enumerate(sorted(pairs)):
        R[(i, j)], truth[(i, j)] = _association(
            rng, clusters[i], clusters[j], spec, idx, thetas[i], thetas[j]
        )
    net = HeteroNetwork(P=P, R=R, type_names=spec.type_names)
    return PlantedKPartite(
        network=net, clusters=clusters, truth=truth, spec=spec
    )


def sizes_for_edges(
    spec: KPartiteSpec, target_edges: int
) -> Tuple[int, ...]:
    """Scale ``spec.sizes`` proportionally so ``num_edges`` lands near
    ``target_edges`` (the paper's Tables 5/6 scale knob, generalized).

    Uses the expected-count model: dense-noise similarity contributes
    ``n_i**2`` nonzeros per type (the drugnet convention — the noise
    floor fills the block), planted-only similarity ``sim_density *
    n_i**2 / k``, and each pair ``2 * p_intra * n_i * n_j / k``.
    """
    r = np.asarray(spec.sizes, dtype=np.float64)
    r = r / r.max()
    k = spec.n_clusters
    if spec.degree == "powerlaw" and not spec.dense_sim_noise:
        # directed keep ≈ d·(1/k + c·(1−1/k)); symmetrized union ≈ ×2
        per_slot = spec.sim_density * (
            1.0 / k + spec.sim_cross_frac * (1.0 - 1.0 / k)
        )
        a_coef = 2.0 * per_slot * float((r**2).sum())
    else:
        a_coef = float((r**2).sum())
    b_coef = (
        2.0
        * spec.p_intra
        * sum(r[i] * r[j] for i, j in spec.resolved_pairs())
        / k
    )
    n_lead = int(np.sqrt(target_edges / max(a_coef + b_coef, 1e-12)))
    return tuple(max(4, int(n_lead * ri)) for ri in r)
