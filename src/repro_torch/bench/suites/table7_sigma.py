"""Paper Table 7: effect of σ on convergence (iterations / runtime)."""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import HeteroLP, LPConfig
from repro_torch.data.drugnet import DrugNetSpec, make_drugnet

SIGMAS = [0.2, 0.1, 0.05, 0.01, 0.005, 0.002]


def run(n_drug: int = 60, n_disease: int = 40, n_target: int = 30,
        seed: int = 0, device=None) -> List[Dict]:
    dn = make_drugnet(DrugNetSpec(
        n_drug=n_drug, n_disease=n_disease, n_target=n_target,
        n_clusters=6, seed=seed,
    ))
    rows = []
    for alg in ["dhlp1", "dhlp2"]:
        for sigma in SIGMAS:
            cfg = LPConfig(alg=alg, alpha=0.5, sigma=sigma)
            solver = HeteroLP(cfg, device=device)
            solver.run(dn.network, seeds=None)  # warm: first-call setup
            t0 = time.time()
            res = solver.run(dn.network)
            rows.append({
                "algorithm": alg, "sigma": sigma,
                "outer_iters": res.outer_iters,
                "inner_iters": res.inner_iters,
                "supersteps": res.supersteps,
                "seconds": time.time() - t0,
            })
    return rows


@register_suite("table7_sigma",
                description="paper Table 7: sigma vs convergence")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    sizes = dict(n_drug=40, n_disease=25, n_target=20) if fast else (
        dict(n_drug=60, n_disease=40, n_target=30)
    )
    rows = run(**sizes, device=device)
    out: List[BenchRecord] = []
    for r in rows:
        out.append(BenchRecord(
            suite="table7_sigma",
            name=f"{r['algorithm']}/s{r['sigma']}",
            backend="dense",
            params={"algorithm": r["algorithm"], "sigma": r["sigma"],
                    **sizes},
            stats=stats_from_samples([r["seconds"]]).to_dict(),
            derived={"outer_iters": float(r["outer_iters"]),
                     "inner_iters": float(r["inner_iters"]),
                     "supersteps": float(r["supersteps"])},
            strict=["outer_iters", "supersteps"],
        ))
    return out
