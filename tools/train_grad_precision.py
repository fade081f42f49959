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
"""

from __future__ import annotations

import sys
from pathlib import Path

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = (("gcn-cora", "full_graph_sm"), ("gat-cora", "full_graph_sm"),
         ("dimenet", "molecule"), ("meshgraphnet", "molecule"))


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

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
