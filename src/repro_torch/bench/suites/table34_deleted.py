"""Paper Tables 3-4: deleted-interaction recovery & pseudo-new-drug.

Table 3: delete ONE known drug-target edge → rank of the deleted target.
Table 4: delete ALL of a drug's targets → how many reappear in the top-k.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import HeteroLP, LPConfig, extract_outputs, rank_of
from repro_torch.data.drugnet import DrugNetSpec, make_drugnet


def run(n_drug: int = 60, n_disease: int = 40, n_target: int = 30,
        n_trials: int = 5, seed: int = 0, device=None) -> List[Dict]:
    dn = make_drugnet(DrugNetSpec(
        n_drug=n_drug, n_disease=n_disease, n_target=n_target,
        n_clusters=6, seed=seed,
    ))
    net = dn.network
    R = net.R[(0, 2)]
    rng = np.random.default_rng(seed)
    drugs = [int(d) for d in np.argwhere((R > 0).sum(axis=1) >= 3).ravel()]
    rng.shuffle(drugs)
    drugs = drugs[:n_trials]
    rows = []
    for alg in ["dhlp1", "dhlp2"]:
        solver = HeteroLP(LPConfig(alg=alg, sigma=1e-3), device=device)
        t0 = time.time()
        ranks, recovered, totals = [], 0, 0
        for drug in drugs:
            targets = np.argwhere(R[drug] > 0).ravel()
            # Table 3: single deletion
            mask = np.zeros_like(R, dtype=bool)
            mask[drug, targets[0]] = True
            masked = net.with_masked_fold((0, 2), mask)
            res = solver.run(masked)
            out = extract_outputs(res.F, masked.normalize())
            ranks.append(rank_of(out.interactions[(0, 2)][drug], targets[0]))
            # Table 4: full deletion (pseudo-new drug)
            mask4 = np.zeros_like(R, dtype=bool)
            mask4[drug, :] = R[drug] > 0
            masked4 = net.with_masked_fold((0, 2), mask4)
            res4 = solver.run(masked4)
            out4 = extract_outputs(res4.F, masked4.normalize())
            scores = out4.interactions[(0, 2)][drug]
            k = len(targets) + 3
            top = set(np.argsort(-scores, kind="stable")[:k].tolist())
            recovered += len(top & set(targets.tolist()))
            totals += len(targets)
        rows.append({
            "algorithm": alg,
            "mean_rank_deleted": float(np.mean(ranks)),
            "median_rank_deleted": float(np.median(ranks)),
            "newdrug_recall_topk": recovered / max(totals, 1),
            "seconds": time.time() - t0,
            "trials": len(drugs),
        })
    return rows


@register_suite("table34_deleted",
                description="paper Tables 3-4: deleted-interaction recovery")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    n_trials = 3 if fast else 10
    rows = run(n_trials=n_trials, device=device)
    out: List[BenchRecord] = []
    for r in rows:
        out.append(BenchRecord(
            suite="table34_deleted", name=r["algorithm"], backend="dense",
            params={"trials": r["trials"], "algorithm": r["algorithm"]},
            stats=stats_from_samples(
                [r["seconds"] / max(r["trials"], 1)]
            ).to_dict(),
            derived={"mean_rank_deleted": r["mean_rank_deleted"],
                     "median_rank_deleted": r["median_rank_deleted"],
                     "newdrug_recall_topk": r["newdrug_recall_topk"]},
            strict=["mean_rank_deleted", "newdrug_recall_topk"],
        ))
    return out
