"""Paper Tables 5-6: runtime scaling, distributed vs non-distributed.

The paper measures MINProp/Heter-LP (single machine) against DHLP-1/2
(6-worker Giraph) on 1M-20M-edge networks and reports Gain = t_base/t_dist.

The mapping here: the *sequential per-seed sweep* (exactly the
non-distributed algorithms' execution model, and also exactly the paper's
per-seed Giraph schedule) vs the *batched multi-source engine* (DESIGN.md
§2), both on the pass's device.  The gain column is therefore the
measured benefit of the batched reformulation — and like the paper's
Tables 5/6 it GROWS with network size.  Edge counts are scaled down.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import HeteroLP, LPConfig
from repro_torch.data.drugnet import DrugNetSpec, make_drugnet


def _edges_to_spec(num_edges: int, seed: int = 0) -> DrugNetSpec:
    r = np.array([223.0, 150.0, 95.0]) / 223.0
    k = 12
    spec0 = DrugNetSpec()
    a = (r ** 2).sum() / k
    pairs = [(0, 1), (0, 2), (1, 2)]
    b = spec0.p_intra * sum(r[i] * r[j] for i, j in pairs) / k
    n_drug = max(12, int(np.sqrt(num_edges / (a + b))))
    return DrugNetSpec(
        n_drug=n_drug, n_disease=max(8, int(n_drug * r[1])),
        n_target=max(6, int(n_drug * r[2])), seed=seed,
    )


def run(edge_counts=(2_000, 8_000, 32_000, 128_000), n_seeds: int = 64,
        alg: str = "dhlp2", sigma: float = 1e-3, device=None) -> List[Dict]:
    rows = []
    for target_edges in edge_counts:
        dn = make_drugnet(_edges_to_spec(target_edges))
        net = dn.network
        n = net.num_nodes
        seeds = np.eye(n)[:, :n_seeds]

        seq = HeteroLP(LPConfig(alg=alg, sigma=sigma, mode="sequential"),
                       device=device)
        bat = HeteroLP(LPConfig(alg=alg, sigma=sigma, mode="batched"),
                       device=device)

        # warmup: first-call setup excluded from timing
        bat.run(net, seeds=seeds[:, :2])
        t0 = time.time()
        seq.run(net, seeds=seeds)
        t_seq = time.time() - t0
        t0 = time.time()
        bat.run(net, seeds=seeds)
        t_bat = time.time() - t0
        rows.append({
            "edges": net.num_edges,
            "nodes": n,
            "t_sequential_s": t_seq,
            "t_batched_s": t_bat,
            "gain": t_seq / max(t_bat, 1e-9),
        })
    return rows


@register_suite("table56_scaling",
                description="paper Tables 5-6: sequential vs batched gain")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    counts = (2_000, 8_000) if fast else (2_000, 8_000, 32_000, 128_000)
    n_seeds = 32 if fast else 128
    rows = run(edge_counts=counts, n_seeds=n_seeds, device=device)
    out: List[BenchRecord] = []
    for r in rows:
        stats = stats_from_samples([r["t_batched_s"]])
        out.append(BenchRecord(
            suite="table56_scaling", name=f"{r['edges']}edges",
            backend="dense",
            params={"edges": r["edges"], "nodes": r["nodes"],
                    "seeds": n_seeds},
            stats=stats.to_dict(),
            derived={
                "gain": r["gain"],
                "t_sequential_s": r["t_sequential_s"],
                "edges_per_s": r["edges"] / max(r["t_batched_s"], 1e-12),
            },
        ))
    return out
