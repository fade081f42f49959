"""Paper Figures 3-4: effect of threads / workers on runtime.

Giraph's threads-per-worker and worker count both map to the mesh size
here.  The suite sweeps the edge-shard count of the distributed DHLP-2
engine (:class:`~repro_torch.parallel.lp_sharded.ShardedHeteroLP`), each
point as k ranks of a child process group
(:func:`~repro_torch.parallel.launch.run_ranks`): NCCL ranks, one card
each, when the pass runs on a card and k cards exist; gloo ranks when it
runs on the CPU; otherwise the point is skipped and the pass says why.
On one host's CPU the sweep measures BSP coordination overhead (more
ranks = more rendezvous on the same cores) rather than speedup.  The full
pass adds the stale-sync sweep (collectives against rounds, DESIGN.md §6).
"""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples

_POINT = "repro_torch.bench.suites.fig34_parallelism:_point"


def _point(payload: Dict) -> Dict:
    """One sweep point, on every rank of its world: a warm solve, then a
    timed one."""
    from repro_torch.core.solver import LPConfig
    from repro_torch.data.drugnet import DrugNetSpec, make_drugnet
    from repro_torch.parallel.lp_sharded import ShardedHeteroLP
    from repro_torch.parallel.mesh import make_mesh

    k, stale, device = payload["devices"], payload["stale"], payload["device"]
    dn = make_drugnet(DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6, seed=0))
    norm = dn.network.normalize()
    mesh = make_mesh((1, k), ("data", "model"), device=device)
    cfg = LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-5)
    solver = ShardedHeteroLP(cfg, stale_sync=stale)
    r = solver.run(norm, mesh)  # operator upload + first run
    t0 = time.perf_counter()
    r = solver.run(norm, mesh)  # returns host F: the card is synchronized
    dt = time.perf_counter() - t0
    return {"devices": k, "stale": stale, "seconds": dt, "iters": int(r.outer_iters),
            "converged": bool(r.converged)}


def run(device, device_counts=(1, 2), stale_syncs=(1,)) -> List[Dict]:
    import torch

    from repro_torch.parallel.launch import run_ranks

    rows = []
    for k in device_counts:
        for stale in stale_syncs:
            cards = torch.cuda.device_count()
            if device.type == "cuda" and k > cards:  # NCCL: one card a rank
                print(f"fig34_parallelism: skipped d{k}s{stale}: needs {k} GPUs, this "
                      f"host has {cards}", flush=True)
                continue
            try:
                rows.append(run_ranks(_POINT, k, {"devices": k, "stale": stale,
                                                  "device": device.type},
                                      device=device.type, timeout=300))
            except Exception as e:  # noqa: BLE001 — an error record, not a hole
                rows.append({"devices": k, "stale": stale, "error": str(e)[-400:]})
    return rows


@register_suite("fig34_parallelism",
                description="paper Figs 3-4: worker-count sweep (child process groups)")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    from repro_torch.device import resolve_device

    rows = run(resolve_device(device),
               device_counts=(1, 2) if fast else (1, 2, 4, 8),
               stale_syncs=(1,) if fast else (1, 4))
    out: List[BenchRecord] = []
    for r in rows:
        name = f"d{r['devices']}s{r['stale']}"
        params = {"devices": r["devices"], "stale_sync": r["stale"]}
        if "error" in r:
            out.append(BenchRecord(
                suite="fig34_parallelism", name=name,
                backend=f"sharded{r['devices']}", params=params,
                error=r["error"],
            ))
        else:
            out.append(BenchRecord(
                suite="fig34_parallelism", name=name,
                backend=f"sharded{r['devices']}", params=params,
                stats=stats_from_samples([r["seconds"]]).to_dict(),
                derived={"iters": float(r["iters"]),
                         "converged": 1.0 if r["converged"] else 0.0},
                strict=["iters", "converged"],
            ))
    return out
