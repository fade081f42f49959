"""The drug / disease / target network of a ``drugnet`` configuration.

A frozen copy of the port's ``powerlaw`` scenario generator, as it stood
at commit ca3ff8b: ``repro_torch.scenarios.generators.planted_kpartite``
(its power-law path, with its RNG draw order), ``sizes_for_edges`` and
``repro_torch.scenarios.library.powerlaw``.  The benchmark owns this copy
so that a change to the program cannot change the network it is measured
on.

The network is drawn once from the configuration's ``network_seed``; the
run's ``--seed`` then relabels the nodes of each type by a permutation.
Every seed so gets the same network (the same sizes, nonzeros and degree
law, hence the same work) presented in another order: drawing a fresh
network per seed moves the nonzeros by a few per cent and the largest
degree by a third (Pareto hubs), which the solve time would follow.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

TypePair = Tuple[int, int]


@dataclasses.dataclass
class Drugnet:
    """A relabelled network: raw blocks, the way users hand them over."""

    P: List[np.ndarray]  # per type, (n_t, n_t) similarity, symmetric
    R: Dict[TypePair, np.ndarray]  # (i, j), i < j: (n_i, n_j) 0/1 associations
    type_names: Tuple[str, ...]

    @property
    def sizes(self) -> List[int]:
        return [p.shape[0] for p in self.P]

    @property
    def offsets(self) -> List[int]:
        return [int(x) for x in np.cumsum([0] + self.sizes[:-1])]

    @property
    def num_nodes(self) -> int:
        return int(sum(self.sizes))

    def operator_nnz(self) -> int:
        """Nonzeros of the normalized propagation operator (H and M)."""
        return int(
            sum(np.count_nonzero(p) for p in self.P)
            + 2 * sum(np.count_nonzero(r) for r in self.R.values())
        )


def _similarity(rng, clusters, g, theta):
    n = clusters.shape[0]
    same = clusters[:, None] == clusters[None, :]
    scale = np.where(same, g["sim_density"], g["sim_density"] * g["sim_cross_frac"])
    keep = rng.random((n, n)) < np.minimum(1.0, scale * np.outer(theta, theta))
    sim = np.where(keep, g["sim_intra"], 0.0)
    if g["dense_sim_noise"]:
        sim = sim + rng.random((n, n)) * g["sim_noise"]
    else:
        sim = sim + keep * (rng.random((n, n)) * g["sim_noise"])
    sim = (sim + sim.T) / 2.0
    np.fill_diagonal(sim, 1.0)
    return sim


def _sizes_for_edges(g) -> Tuple[int, ...]:
    r = np.asarray(g["type_ratio"], dtype=np.float64)
    r = r / r.max()
    k = g["n_clusters"]
    pairs = [(i, j) for i in range(len(r)) for j in range(i + 1, len(r))]
    if not g["dense_sim_noise"]:
        per_slot = g["sim_density"] * (1.0 / k + g["sim_cross_frac"] * (1.0 - 1.0 / k))
        a_coef = 2.0 * per_slot * float((r**2).sum())
    else:
        a_coef = float((r**2).sum())
    b_coef = 2.0 * g["p_intra"] * sum(r[i] * r[j] for i, j in pairs) / k
    n_lead = int(np.sqrt(g["target_edges"] / max(a_coef + b_coef, 1e-12)))
    return tuple(max(4, int(n_lead * ri)) for ri in r)


def base_network(g: dict) -> Drugnet:
    """The configuration's network, in the generator's own labelling."""
    sizes = _sizes_for_edges(g)
    rng = np.random.default_rng(g["network_seed"])
    k = g["n_clusters"]
    clusters = [rng.integers(0, k, size=n).astype(np.int32) for n in sizes]
    a = g["powerlaw_exponent"]
    thetas = []
    for n in sizes:
        t = 1.0 + rng.pareto(a, size=n)
        thetas.append(t * (a - 1.0) / a if a > 1.0 else t)
    P = [_similarity(rng, c, g, th) for c, th in zip(clusters, thetas)]
    R = {}
    pairs = [(i, j) for i in range(len(sizes)) for j in range(i + 1, len(sizes))]
    for i, j in pairs:
        match = clusters[i][:, None] == clusters[j][None, :]
        p = np.where(match, g["p_intra"], g["p_noise"])
        p = np.minimum(1.0, p * np.outer(thetas[i], thetas[j]))
        R[(i, j)] = (rng.random((sizes[i], sizes[j])) < p).astype(np.float64)
    return Drugnet(P=P, R=R, type_names=tuple(g["type_names"]))


def relabel(net: Drugnet, seed: int) -> Drugnet:
    """The same network with each type's nodes permuted by ``seed``."""
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(n) for n in net.sizes]
    P = [p[np.ix_(q, q)] for p, q in zip(net.P, perms)]
    R = {(i, j): r[np.ix_(perms[i], perms[j])] for (i, j), r in net.R.items()}
    return Drugnet(P=P, R=R, type_names=net.type_names)


def make(config: dict, seed: int) -> Drugnet:
    return relabel(base_network(config["generator"]), seed)
