"""Kernel-variant A/B cells: pre-fusion loop vs fused superstep vs bf16
storage (DESIGN.md §15), on the blocked-CSR ``sparse`` engine:

* ``drugnet_*`` — the case-study network solved by every variant, with
  fixed-point agreement against the dense reference strict-gated (bf16
  rides the same ``AGREEMENT_TOL`` bar as every other backend);
* ``powerlaw_race_*`` — a >=100k-edge heavy-tailed network, fused
  superstep raced against the pre-fusion per-round path it replaced
  (``speedup_vs_legacy`` on the fused record).

Each timed cell also carries the analytic roofline terms
(:mod:`repro_torch.bench.roofline`): per-round achieved FLOP/s and
bandwidth against the card's H100 peak table, with the deterministic
FLOP/byte counts strict-gated — they change only when the round's math
changes.

The reference's ``drugnet_autotuned`` and ``autotune_cache`` cells time
the autotune sweep, which this package does not have yet (``ROADMAP.md``
queue A.7: every engine resolves to ``DEFAULT_PARAMS``); they are not
emitted, and the pass says so.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.bench.matrix import AGREEMENT_TOL
from repro_torch.bench.registry import register_suite
from repro_torch.bench.roofline import achieved_vs_peak, device_peak_model, lp_round_cost
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import derived_throughput, time_callable

SIGMA = 1e-4
SEED_COLS = 16
#: powerlaw edge-target scale — 0.2 of the 1.2M nominal ≈ 240k edges,
#: comfortably past the scenario disk-cache floor so generation is paid once
RACE_SCALE = 0.2
RACE_SIGMA = 1e-3
RACE_SEED_COLS = 8

#: (cell label, LPConfig overrides, engine kwargs)
VARIANTS = (
    ("legacy", {"autotune": False}, {"fused_superstep": False}),
    ("fused", {"autotune": False}, {}),
    ("bf16", {"autotune": False, "storage_dtype": "bf16"}, {}),
)


def _roofline_terms(
    stats, *, nnz: int, num_nodes: int, s: int, supersteps: int,
    storage_bytes: int, model: str,
) -> Dict[str, float]:
    cost = lp_round_cost(
        nnz=nnz, num_nodes=num_nodes, s=s, storage_bytes=storage_bytes
    )
    round_s = stats.median_s / max(supersteps, 1)
    out = achieved_vs_peak(round_s, cost, model)
    out["round_flops"] = cost["flops"]
    out["round_bytes"] = cost["bytes"]
    return out


def _solve_record(
    name: str,
    variant: str,
    cfg_overrides: Dict[str, object],
    engine_kwargs: Dict[str, object],
    norm,
    Y: np.ndarray,
    *,
    sigma: float,
    nnz: int,
    edges: int,
    device,
    F_ref: np.ndarray = None,
    repeats: int = 3,
):
    """Time one variant's full solve; agreement is vs ``F_ref``.
    Returns the record, the median and the fixed point."""
    from repro_torch.core.solver import LPConfig
    from repro_torch.engine import make_engine

    cfg = LPConfig(alg="dhlp2", sigma=sigma, seed_mode="fixed", **cfg_overrides)
    engine = make_engine("sparse", cfg, device=device, **engine_kwargs)

    def solve():
        return engine.run(norm, seeds=Y)

    res = solve()  # warmup: plan build + first run
    stats = time_callable(solve, warmup=0, repeats=repeats)
    storage_bytes = 2 if cfg_overrides.get("storage_dtype") == "bf16" else 4
    model = device_peak_model(device)
    derived = derived_throughput(stats, edges=edges, supersteps=res.supersteps)
    derived.update(
        _roofline_terms(
            stats,
            nnz=nnz,
            num_nodes=norm.num_nodes,
            s=Y.shape[1],
            supersteps=int(res.supersteps),
            storage_bytes=storage_bytes,
            model=model,
        )
    )
    derived["outer_iters"] = float(res.outer_iters)
    derived["supersteps"] = float(res.supersteps)
    strict = ["outer_iters", "supersteps", "round_flops", "round_bytes"]
    if F_ref is not None:
        diff = float(np.max(np.abs(res.F - F_ref)))
        derived["agree_ref"] = 1.0 if diff <= AGREEMENT_TOL else 0.0
        derived["max_abs_diff_vs_ref"] = diff
        strict.append("agree_ref")
    rec = BenchRecord(
        suite="kernel_variants",
        name=name,
        backend="sparse",
        params={
            "variant": variant,
            "alg": "dhlp2",
            "sigma": sigma,
            "nodes": int(norm.num_nodes),
            "edges": int(edges),
            "nnz": int(nnz),
            "seeds": int(Y.shape[1]),
            "storage_dtype": cfg_overrides.get("storage_dtype", "f32"),
            "fused": bool(engine_kwargs.get("fused_superstep", True)),
            "peak_model": model,
        },
        stats=stats.to_dict(),
        derived=derived,
        strict=strict,
    )
    return rec, stats.median_s, res.F


def _drugnet_records(fast: bool, device) -> List[BenchRecord]:
    """Every variant on the case-study network, gated against dense."""
    from repro_torch.core.solver import HeteroLP, LPConfig
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
    from repro_torch.engine.autotune import network_nnz

    if fast:
        spec_net = DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6)
    else:
        spec_net = DrugNetSpec(n_drug=96, n_disease=64, n_target=48, n_clusters=8)
    dn = make_drugnet(spec_net)
    norm = dn.network.normalize()
    n = norm.num_nodes
    nnz = network_nnz(norm)
    edges = dn.network.num_edges
    Y = np.eye(n, dtype=np.float32)[:, :SEED_COLS]
    F_dense = (
        HeteroLP(LPConfig(alg="dhlp2", sigma=SIGMA, seed_mode="fixed"), device=device)
        .run(norm, seeds=Y)
        .F
    )
    out: List[BenchRecord] = []
    for variant, cfg_over, eng_kw in VARIANTS:
        rec, _, _ = _solve_record(
            f"drugnet_{variant}",
            variant,
            cfg_over,
            eng_kw,
            norm,
            Y,
            sigma=SIGMA,
            nnz=nnz,
            edges=edges,
            device=device,
            F_ref=F_dense,
            repeats=5 if fast else 3,
        )
        # vs-dense naming: this group's reference IS the dense engine
        rec.derived["agree_dense"] = rec.derived.pop("agree_ref")
        rec.derived["max_abs_diff_vs_dense"] = rec.derived.pop("max_abs_diff_vs_ref")
        rec.strict[rec.strict.index("agree_ref")] = "agree_dense"
        out.append(rec)
    return out


def _powerlaw_race_records(device) -> List[BenchRecord]:
    """Fused superstep vs the pre-fusion loop on a >=100k-edge network."""
    import repro_torch.scenarios as sc
    from repro_torch.engine.autotune import network_nnz

    bundle = sc.generate("powerlaw", scale=RACE_SCALE, seed=0)
    net = bundle.network
    norm = net.normalize()
    n = norm.num_nodes
    nnz = network_nnz(norm)
    Y = np.zeros((n, RACE_SEED_COLS), dtype=np.float32)
    Y[np.arange(RACE_SEED_COLS), np.arange(RACE_SEED_COLS)] = 1.0

    legacy, legacy_s, F_legacy = _solve_record(
        "powerlaw_race_legacy",
        "legacy",
        {"autotune": False},
        {"fused_superstep": False},
        norm,
        Y,
        sigma=RACE_SIGMA,
        nnz=nnz,
        edges=net.num_edges,
        device=device,
    )
    fused, fused_s, _ = _solve_record(
        "powerlaw_race_fused",
        "fused",
        {"autotune": False},
        {},
        norm,
        Y,
        sigma=RACE_SIGMA,
        nnz=nnz,
        edges=net.num_edges,
        device=device,
        F_ref=F_legacy,
    )
    fused.derived["speedup_vs_legacy"] = legacy_s / max(fused_s, 1e-12)
    return [legacy, fused]


@register_suite(
    "kernel_variants",
    description="fused-superstep / bf16 A-B cells with H100 roofline "
    "achieved-vs-peak terms",
)
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    print(
        "kernel_variants: skipped drugnet_autotuned, autotune_cache: the "
        "autotune sweep is not ported (ROADMAP A.7)",
        flush=True,
    )
    out: List[BenchRecord] = []
    out.extend(_drugnet_records(fast, device))
    out.extend(_powerlaw_race_records(device))
    return out
