"""Planted-truth evaluation protocols over scenario bundles.

Two protocols, both scored against the generator's construction ground
truth (noise edges are neither positives nor negatives — they are
excluded from every evaluation set):

* **recovery** — hide a fraction of the planted positives of one pair,
  re-solve on any engine-registry backend, and rank the held-out entries
  against the true negatives of the same rows.  Seeds are only the rows
  that lost an edge (capped at ``max_entities``), so the protocol scales
  to the million-edge scenarios where all-pairs solves are off the
  table.
* **k-fold CV** — the paper's Table 2 protocol (``eval/cv.py``) with the
  positive set overridden to the planted truth, so it runs unchanged on
  any T-type scenario.

Every solve runs on an engine from :func:`repro_torch.engine.make_engine`
on the caller's ``device`` (``None`` = ``cuda:0``; the CPU only when asked
for with ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.network import HeteroNetwork, TypePair, seeds_for_nodes
from repro_torch.core.solver import LPConfig
from repro_torch.device import DeviceLike
from repro_torch.eval.cv import FoldResult, cross_validate
from repro_torch.eval.metrics import auc_score, aupr_score
from repro_torch.scenarios.base import ScenarioBundle


def default_lp_config(sigma: float = 1e-4) -> LPConfig:
    """Serving-grade solve config: fused DHLP-2, fixed seeds."""
    return LPConfig(alg="dhlp2", sigma=sigma, seed_mode="fixed")


@dataclasses.dataclass
class RecoveryProblem:
    """A masked solve whose answer is scored against planted truth."""

    bundle: ScenarioBundle
    pair: TypePair
    masked_net: HeteroNetwork
    #: seed columns — one per evaluated entity (rows of ``pair``'s block)
    Y: np.ndarray
    rows: np.ndarray          # (B,) local row ids within type pair[0]
    heldout: np.ndarray       # (n_i, n_j) bool — hidden planted positives
    negatives: np.ndarray     # (n_i, n_j) bool — true negatives
    target_slice: slice

    @property
    def num_heldout(self) -> int:
        return int(self.heldout[self.rows].sum())

    def scores_from_F(self, F: np.ndarray) -> np.ndarray:
        """(B, n_j) score block for the evaluated rows."""
        return np.asarray(F[self.target_slice, :], dtype=np.float64).T

    def metrics(self, F: np.ndarray) -> Dict[str, float]:
        scores = self.scores_from_F(F)
        s, labels = [], []
        for b, u in enumerate(self.rows):
            mask = self.heldout[u] | self.negatives[u]
            s.append(scores[b, mask])
            labels.append(self.heldout[u, mask])
        sv = np.concatenate(s)
        lv = np.concatenate(labels)
        return {
            "recovery_auc": auc_score(sv, lv),
            "recovery_aupr": aupr_score(sv, lv),
            "eval_entities": float(len(self.rows)),
            "heldout_edges": float(self.num_heldout),
        }


def make_recovery_problem(
    bundle: ScenarioBundle,
    pair: Optional[TypePair] = None,
    *,
    holdout_frac: float = 0.1,
    max_entities: int = 32,
    seed: int = 0,
) -> RecoveryProblem:
    """Hide ``holdout_frac`` of the pair's planted positives; seed the
    rows that lost one (subsampled to ``max_entities``)."""
    pair = bundle.eval_pair if pair is None else (min(pair), max(pair))
    net = bundle.network
    R = net.R[pair]
    planted = bundle.truth[pair] & (R > 0)
    pos = np.argwhere(planted)
    if len(pos) < 2:
        raise ValueError(f"pair {pair} has too few planted positives")
    rng = np.random.default_rng(seed)
    n_hold = max(1, int(len(pos) * holdout_frac))
    sel = pos[rng.choice(len(pos), size=n_hold, replace=False)]
    heldout = np.zeros_like(planted)
    heldout[sel[:, 0], sel[:, 1]] = True

    rows = np.unique(sel[:, 0])
    if len(rows) > max_entities:
        rows = rng.choice(rows, size=max_entities, replace=False)
        rows.sort()
    i, j = pair
    masked = net.with_masked_fold(pair, heldout)
    Y = seeds_for_nodes(net.num_nodes, list(net.offsets[i] + rows))
    off_j = net.offsets[j]
    return RecoveryProblem(
        bundle=bundle,
        pair=pair,
        masked_net=masked,
        Y=Y,
        rows=rows,
        heldout=heldout,
        negatives=(R == 0) & ~bundle.truth[pair],
        target_slice=slice(off_j, off_j + net.sizes[j]),
    )


def solve_recovery(
    problem: RecoveryProblem,
    backend: str = "auto",
    *,
    lp: Optional[LPConfig] = None,
    device: DeviceLike = None,
    **engine_kw,
):
    """Run the masked solve on one registry backend; returns SolveResult."""
    from repro_torch.engine import make_engine

    cfg = lp or default_lp_config()
    engine = make_engine(
        backend,
        cfg,
        num_nodes=problem.masked_net.num_nodes,
        device=device,
        **engine_kw,
    )
    return engine.run(problem.masked_net, seeds=problem.Y)


def recovery_auc(
    bundle: ScenarioBundle,
    backend: str = "auto",
    *,
    pair: Optional[TypePair] = None,
    holdout_frac: float = 0.1,
    max_entities: int = 32,
    seed: int = 0,
    lp: Optional[LPConfig] = None,
    device: DeviceLike = None,
    **engine_kw,
) -> Dict[str, float]:
    """Convenience: problem + solve + metrics in one call."""
    problem = make_recovery_problem(
        bundle,
        pair,
        holdout_frac=holdout_frac,
        max_entities=max_entities,
        seed=seed,
    )
    res = solve_recovery(problem, backend, lp=lp, device=device, **engine_kw)
    out = problem.metrics(res.F)
    out["outer_iters"] = float(res.outer_iters)
    return out


def backend_solver_fn(
    bundle: ScenarioBundle,
    pair: TypePair,
    backend: str = "auto",
    *,
    lp: Optional[LPConfig] = None,
    engine=None,
    device: DeviceLike = None,
    **engine_kw,
):
    """A ``cross_validate``-compatible solver over a registry backend.

    Seeds every node of the pair's source type and returns the
    ``(n_i, n_j)`` predicted score block — the full-matrix protocol the
    small scenarios use for k-fold CV.  Pass a prebuilt ``engine`` to
    reuse one instance across every fold.
    """
    from repro_torch.engine import make_engine

    i, j = min(pair), max(pair)
    cfg = lp or default_lp_config()

    def solver(masked_net: HeteroNetwork) -> np.ndarray:
        nonlocal engine
        if engine is None:
            engine = make_engine(
                backend,
                cfg,
                num_nodes=masked_net.num_nodes,
                device=device,
                **engine_kw,
            )
        off_i, off_j = masked_net.offsets[i], masked_net.offsets[j]
        n_i, n_j = masked_net.sizes[i], masked_net.sizes[j]
        Y = seeds_for_nodes(
            masked_net.num_nodes, list(range(off_i, off_i + n_i))
        )
        res = engine.run(masked_net, seeds=Y)
        return np.asarray(res.F[off_j : off_j + n_j, :], np.float64).T

    return solver


def scenario_cross_validate(
    bundle: ScenarioBundle,
    *,
    pair: Optional[TypePair] = None,
    backend: str = "auto",
    k: int = 5,
    seed: int = 0,
    lp: Optional[LPConfig] = None,
    engine=None,
    device: DeviceLike = None,
) -> List[FoldResult]:
    """The Table 2 k-fold protocol against the scenario's planted truth."""
    pair = bundle.eval_pair if pair is None else (min(pair), max(pair))
    positives = bundle.truth[pair] & (bundle.network.R[pair] > 0)
    return cross_validate(
        bundle.network,
        pair,
        backend_solver_fn(
            bundle, pair, backend, lp=lp, engine=engine, device=device
        ),
        k=k,
        seed=seed,
        positives=positives,
    )
