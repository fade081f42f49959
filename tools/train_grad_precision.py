#!/usr/bin/env python3
"""How close the GNN train cells' f32 gradients come to exact arithmetic,
on the card and on the CPU (ROADMAP C.3).

For each train cell that ``chip_smoke.py`` phase 18 holds card against
CPU (``gcn-cora`` and ``gat-cora`` at ``full_graph_sm``, ``dimenet`` and
``meshgraphnet`` at ``molecule``; the same batches, built by
``chip_smoke.gnn_train_batch``), one step's gradients in f32 on the card
and on the CPU and in f64 on the card (the plain route, every op in f64)
are compared leaf by leaf at ``rtol=1e-4, atol=1e-5``: the leaves past it
and the largest difference for card vs CPU, card vs f64 and CPU vs f64.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/train_grad_precision.py

``--bisect`` needs no card: on the CPU it runs MeshGraphNet ``FULL`` at
``molecule`` (the same batch builder, CPU draws) in f32 and in f64, then
in f32 with one group of ops lifted to f64 at a time (the MLPs whole, the
LayerNorms, the scatter-sum aggregation, the MLPs' products alone), and
prints for each the leaves past the tolerance against the f64 run and the
largest difference: the op whose lift closes the gap is the one that
loses the precision.

    python3 tools/train_grad_precision.py --bisect
"""

from __future__ import annotations

import sys
from pathlib import Path

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = (("gcn-cora", "full_graph_sm"), ("gat-cora", "full_graph_sm"),
         ("dimenet", "molecule"), ("meshgraphnet", "molecule"))


def bisect(torch, np) -> int:
    """MeshGraphNet's f32 gradients on the CPU with one op group in f64."""
    import chip_smoke as c
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.optim import tree_leaves, tree_map, value_and_grad

    dev = torch.device("cpu")
    cell = get_arch("meshgraphnet").make_cell("molecule")
    batch = c.gnn_train_batch(torch, np, dev, cell, "molecule")
    params, _ = cell.step_fn.init(torch.Generator(device=dev).manual_seed(0), dev)
    f64 = lambda t: t.detach().double() if t.is_floating_point() else t  # noqa: E731
    exact = [t.detach() for t in tree_leaves(value_and_grad(
        cell.step_fn.loss_fn, tree_map(f64, params), {k: f64(v) for k, v in batch.items()})[1])]
    orig = {"mlp": gnn.mlp, "layer_norm": gnn.layer_norm, "segment_sum": gnn.segment_sum}

    up = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731 (keeps autograd)

    def lifted(fn):  # fn in f64, its result rounded once to f32
        def run(*args, **kw):
            args = [[up(t) for t in a] if isinstance(a, list) else
                    (up(a) if isinstance(a, torch.Tensor) else a) for a in args]
            return fn(*args, **kw).float()
        return run

    def products_lifted(x, weights, biases, act=torch.relu):
        h = x
        for i, (w, b) in enumerate(zip(weights, biases)):
            h = (h.double() @ w.double()).float() + b
            h = act(h) if i < len(weights) - 1 else h
        return h

    cases = [("f32", {}), ("MLPs in f64", {"mlp": lifted(orig["mlp"])}),
             ("LayerNorms in f64", {"layer_norm": lifted(orig["layer_norm"])}),
             ("scatter-sums in f64", {"segment_sum": lifted(orig["segment_sum"])}),
             ("MLP products alone in f64", {"mlp": products_lifted})]
    print(f"meshgraphnet molecule on the CPU ({len(exact)} leaves), each against f64:")
    try:
        for label, patch in cases:
            for k, fn in orig.items():
                setattr(gnn, k, patch.get(k, fn))
            got = [t.detach().double() for t in tree_leaves(
                value_and_grad(cell.step_fn.loss_fn, params, batch)[1])]
            missed = sum(not torch.allclose(a, b, **TOL) for a, b in zip(got, exact))
            worst = max(float((a - b).abs().max()) for a, b in zip(got, exact))
            print(f"  {label}: {missed} past, max|Δ| {worst:.3e}", flush=True)
    finally:
        for k, fn in orig.items():
            setattr(gnn, k, fn)
    return 0


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    if "--bisect" in sys.argv[1:]:
        return bisect(torch, np)

    if not torch.cuda.is_available():
        print("train_grad_precision: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch.configs import cells, get_arch
    from repro_torch.optim import tree_leaves, tree_map, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(c.smi_name_and_limit())
    for arch, shape in CASES:
        spec = get_arch(arch)
        cell = spec.make_cell(shape)
        plain = (cells.gnn_cell(arch, spec.full_config, shape, use_kernel=False)
                 if arch in ("gcn-cora", "gat-cora") else cell)
        batch = c.gnn_train_batch(torch, np, dev, cell, shape)
        params, _ = cell.step_fn.init(torch.Generator(device=dev).manual_seed(0), dev)
        f64 = lambda t: t.detach().double() if t.is_floating_point() else t  # noqa: E731
        cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
        runs = {
            "card": value_and_grad(cell.step_fn.loss_fn, params, batch)[1],
            "CPU": value_and_grad(cell.step_fn.loss_fn, tree_map(cpu, params),
                                  {k: v.cpu() for k, v in batch.items()})[1],
            "f64": value_and_grad(plain.step_fn.loss_fn, tree_map(f64, params),
                                  {k: f64(v) for k, v in batch.items()})[1],
        }
        leaves = {k: [t.detach().cpu().double() for t in tree_leaves(v)] for k, v in runs.items()}
        parts = []
        for a, b in (("card", "CPU"), ("card", "f64"), ("CPU", "f64")):
            pairs = list(zip(leaves[a], leaves[b]))
            missed = sum(not torch.allclose(x, y, **TOL) for x, y in pairs)
            worst = max(float((x - y).abs().max()) for x, y in pairs)
            parts.append(f"{a} vs {b}: {missed} past, max|Δ| {worst:.3e}")
        print(f"{arch} {shape} ({len(leaves['card'])} leaves): " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
