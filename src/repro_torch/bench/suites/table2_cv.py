"""Paper Table 2: 10-fold CV accuracy (AUC/AUPR/BestACC) for DHLP-1,
DHLP-2, MINProp and Heter-LP on the synthetic gold-standard network.

The DHLP solves run on the pass's device; MINProp and Heter-LP (full
pass only) are the per-seed numpy loops of :mod:`repro_torch.core.reference`.
"""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import HeteroLP, LPConfig, extract_outputs, run_all_seeds
from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
from repro_torch.eval import cross_validate, summarize

PAIRS = {(0, 1): "drug-disease", (0, 2): "drug-target",
         (1, 2): "disease-target"}


def _dhlp_solver(alg: str, pair, device):
    def fn(masked_net):
        norm = masked_net.normalize()
        res = HeteroLP(LPConfig(alg=alg, alpha=0.5, sigma=1e-3),
                       device=device).run(masked_net)
        return extract_outputs(res.F, norm).interactions[pair]

    return fn


def _reference_solver(alg: str, pair):
    def fn(masked_net):
        norm = masked_net.normalize()
        res = run_all_seeds(norm, alg=alg, alpha=0.5, sigma=1e-3)
        return extract_outputs(res.F, norm).interactions[pair]

    return fn


def run(
    n_drug: int = 60, n_disease: int = 40, n_target: int = 30,
    folds: int = 5, include_references: bool = True, seed: int = 0,
    device=None,
) -> List[Dict]:
    dn = make_drugnet(DrugNetSpec(
        n_drug=n_drug, n_disease=n_disease, n_target=n_target,
        n_clusters=6, seed=seed,
    ))
    rows = []
    for pair, name in PAIRS.items():
        for alg in ["dhlp1", "dhlp2"] + (
            ["minprop", "heterlp"] if include_references else []
        ):
            solver = (
                _dhlp_solver(alg, pair, device) if alg.startswith("dhlp")
                else _reference_solver(alg, pair)
            )
            t0 = time.time()
            res = cross_validate(dn.network, pair, solver, k=folds,
                                 seed=seed)
            summary = summarize(res)
            rows.append({
                "interaction": name, "algorithm": alg,
                "auc": summary["auc"], "aupr": summary["aupr"],
                "best_acc": summary["best_acc"],
                "seconds": time.time() - t0,
            })
    return rows


@register_suite("table2_cv",
                description="paper Table 2: 10-fold CV AUC/AUPR/BestACC")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    folds = 5
    rows = run(include_references=not fast, folds=folds, device=device)
    out: List[BenchRecord] = []
    for r in rows:
        out.append(BenchRecord(
            suite="table2_cv",
            name=f"{r['interaction']}/{r['algorithm']}",
            backend="dense",
            params={"folds": folds, "interaction": r["interaction"],
                    "algorithm": r["algorithm"]},
            # per-fold wall time so the number survives fold-count changes
            stats=stats_from_samples([r["seconds"] / folds]).to_dict(),
            derived={"auc": r["auc"], "aupr": r["aupr"],
                     "best_acc": r["best_acc"]},
            strict=["auc", "aupr", "best_acc"],
        ))
    return out
