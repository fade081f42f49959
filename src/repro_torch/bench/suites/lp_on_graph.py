"""Arch-applicability demonstration: the paper's LP core as a
semi-supervised node classifier on the GNN pool's graphs (the port of
``benchmarks/lp_on_graph.py``).

A homogeneous graph is the T=1 special case of the heterogeneous network
(no cross-type blocks); seeding Y with one column per class and the
labeled nodes as seeds recovers Zhou et al.'s classic label propagation,
the algorithm family DHLP generalizes.  Held-out accuracy is compared
with a GCN trained on the same planted-partition graph: 60 AdamW steps
through the port's GCN, which aggregates on B4 forward and backward on
the card (:class:`~repro_torch.kernels.segment_reduce.CSRAggregate`).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import HeteroNetwork, LPConfig, symmetric_normalize
from repro_torch.data.graphs import planted_partition_graph
from repro_torch.device import resolve_device


def lp_classify(data, sigma=1e-4, alpha=0.9, backend="dense", device=None):
    from repro_torch.engine import make_engine

    net = HeteroNetwork(P=[data.edges.to_dense()], R={})
    n = data.edges.num_nodes
    y = np.zeros((n, data.n_classes))
    for c in range(data.n_classes):
        y[(data.labels == c) & data.train_mask, c] = 1.0
    # the sparse cell runs momentum-free so its timing is comparable to
    # historical layout-vs-layout baselines at identical round counts;
    # dense keeps the accelerated configuration
    cfg = LPConfig(
        alg="dhlp2", seed_mode="fixed", alpha=alpha, sigma=sigma,
        momentum=0.2 if backend == "dense" else 0.0,
    )
    res = make_engine(backend, cfg, device=device).run(net, seeds=y)
    return np.argmax(res.F, axis=1), res


def gcn_classify(data, steps=60, device=None):
    from repro_torch.configs.cells import _masked_ce
    from repro_torch.graph.structures import EdgeList
    from repro_torch.models.gnn import GCN, GCNConfig, csr_operator, gcn_forward_csr
    from repro_torch.optim import adamw, make_train_step

    dev = resolve_device(device)
    n = data.edges.num_nodes
    el = EdgeList.from_dense(symmetric_normalize(data.edges.to_dense()))
    cfg = GCNConfig(name="lp-vs-gcn", d_feat=data.feats.shape[1],
                    n_classes=data.n_classes, d_hidden=16)
    params = GCN(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev).param_tree()
    opt = adamw(1e-2)
    state = opt.init(params)
    feats = torch.from_numpy(data.feats).to(dev)
    src, dst, w = (torch.from_numpy(a).to(dev) for a in (el.src, el.dst, el.weights()))
    op = csr_operator(src, dst, w, n)  # the padded CSR and its transpose, once
    labels = torch.from_numpy(data.labels).to(dev)
    mask = torch.from_numpy(data.train_mask.astype(np.float32)).to(dev)

    def logits_of(p):
        return gcn_forward_csr(p, feats, op.nbr, op.wgt, op.live, op.transpose)

    step = make_train_step(lambda p, _: _masked_ce(logits_of(p), labels, mask), opt)
    for _ in range(steps):
        params, state, _ = step(params, state, None)
    with torch.no_grad():
        return logits_of(params).argmax(dim=1).cpu().numpy()


def run(n_nodes=400, n_edges=2400, n_classes=5, d_feat=16, seed=0,
        device=None) -> List[Dict]:
    data = planted_partition_graph(n_nodes, n_edges, n_classes, d_feat,
                                   homophily=0.85, train_frac=0.1, seed=seed,
                                   device=device)
    test = ~data.train_mask
    rows = []
    # dense + blocked-CSR (the sparse cell timed on its second call, the
    # dense cell on its first, as the reference times them)
    lp_cells = [
        ("dhlp2_lp", "dense"),
        ("dhlp2_lp_csr", "sparse"),
    ]
    for method, backend in lp_cells:
        if backend != "dense":
            lp_classify(data, backend=backend, device=device)  # warm-up
        t0 = time.time()
        lp_pred, res = lp_classify(data, backend=backend, device=device)
        rows.append({
            "method": method, "backend": backend,
            "seconds": time.time() - t0,
            "test_acc": float((lp_pred[test] == data.labels[test]).mean()),
            "iters": res.outer_iters,
        })
    t0 = time.time()
    gcn_pred = gcn_classify(data, device=device)
    rows.append({
        "method": "gcn", "backend": "gcn", "seconds": time.time() - t0,
        "test_acc": float((gcn_pred[test] == data.labels[test]).mean()),
        "iters": 60,
    })
    return rows


@register_suite("lp_on_graph",
                description="LP core vs trained GCN on planted partitions")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    n_nodes = 300 if fast else 1000
    n_edges = 1800 if fast else 8000
    rows = run(n_nodes=n_nodes, n_edges=n_edges, device=device)
    out: List[BenchRecord] = []
    for r in rows:
        out.append(BenchRecord(
            suite="lp_on_graph", name=r["method"],
            backend=r["backend"],
            params={"n_nodes": n_nodes, "n_edges": n_edges},
            stats=stats_from_samples([r["seconds"]]).to_dict(),
            derived={"test_acc": r["test_acc"], "iters": float(r["iters"])},
            strict=["test_acc", "iters"],
        ))
    return out
