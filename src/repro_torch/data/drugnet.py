"""Synthetic drug–disease–target gold-standard generator.

The paper's accuracy experiments run on the Yamanishi-08 gold standard
(four target families; GPCR: 223 drugs × 95 targets) extended with disease
associations by Heter-LP [14].  That dataset is not shipped with the
repository, so networks with the same *structure* are generated: latent
mechanism clusters shared by the three concept types, noisy
intra-cluster similarity, and sparse planted associations.

A thin adapter over the k-partite planted-structure generator in
:mod:`repro_torch.scenarios.generators`, configured tri-partite (the
``bio_tri`` scenario).  The numpy RNG streams are those of ``repro``'s
``make_drugnet``, so a spec gives bit-identical networks in both packages.

Because interactions are *planted*, CV can verify that LP recovers held-out
edges — the same protocol as the paper's Table 2, with ground truth known by
construction.  Statistics (sizes, density) default to the GPCR scale.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.network import HeteroNetwork
from repro_torch.scenarios.generators import KPartiteSpec, planted_kpartite


@dataclasses.dataclass(frozen=True)
class DrugNetSpec:
    n_drug: int = 223
    n_disease: int = 150
    n_target: int = 95
    n_clusters: int = 12
    # probability of an association within / across matched clusters
    p_intra: float = 0.9
    p_noise: float = 0.0005
    # similarity strengths
    sim_intra: float = 0.8
    sim_noise: float = 0.02
    seed: int = 0

    def to_kpartite(self) -> KPartiteSpec:
        """The equivalent generic generator spec (``bio_tri`` shape)."""
        return KPartiteSpec(
            sizes=(self.n_drug, self.n_disease, self.n_target),
            n_clusters=self.n_clusters,
            p_intra=self.p_intra,
            p_noise=self.p_noise,
            sim_intra=self.sim_intra,
            sim_noise=self.sim_noise,
            type_names=("drug", "disease", "target"),
            seed=self.seed,
        )


@dataclasses.dataclass
class DrugNet:
    network: HeteroNetwork
    clusters: Tuple[np.ndarray, np.ndarray, np.ndarray]
    spec: DrugNetSpec
    #: planted positives per pair (noise edges excluded)
    truth: Optional[Dict[Tuple[int, int], np.ndarray]] = None

    @property
    def pair_names(self) -> Dict[Tuple[int, int], str]:
        return {
            (0, 1): "drug-disease",
            (0, 2): "drug-target",
            (1, 2): "disease-target",
        }


def make_drugnet(spec: DrugNetSpec = DrugNetSpec()) -> DrugNet:
    pk = planted_kpartite(spec.to_kpartite())
    return DrugNet(
        network=pk.network, clusters=pk.clusters, spec=spec, truth=pk.truth
    )


def make_scaling_network(
    num_edges: int, seed: int = 0
) -> DrugNet:
    """Network sized to hit approximately ``num_edges`` total edges —
    the knob the paper's Tables 5/6 sweep from 1M to 20M.

    Edge count is dominated by the similarity matrices (intra-cluster
    cliques): |E| ≈ Σ_types n·(n/k)·sim_density + associations.  It solves
    for n given the default density parameters.
    """
    spec0 = DrugNetSpec(seed=seed)
    # per-type intra-cluster clique edges ≈ n²/k; three types with the
    # default drug:disease:target ratio r = (223, 150, 95)/223
    r = np.array([223.0, 150.0, 95.0]) / 223.0
    k = spec0.n_clusters
    # total ≈ Σ (r_i·n)²/k  + assoc ≈ p_intra·Σ_pairs r_i r_j n²/k
    a = (r ** 2).sum() / k
    pairs = [(0, 1), (0, 2), (1, 2)]
    b = spec0.p_intra * sum(r[i] * r[j] for i, j in pairs) / k
    n_drug = int(np.sqrt(num_edges / (a + b)))
    spec = DrugNetSpec(
        n_drug=n_drug,
        n_disease=int(n_drug * r[1]),
        n_target=int(n_drug * r[2]),
        seed=seed,
    )
    return make_drugnet(spec)
