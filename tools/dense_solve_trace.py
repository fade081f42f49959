#!/usr/bin/env python3
"""The dense ``lp_round`` solve of ``chip_smoke.py``'s phase 5, traced on the card.

Runs the DHLP-2 fixed-seed all-sources solve on the dense engine with
``use_kernel=True`` (one B2 ``lp_round`` launch per round) at ``powerlaw``
scale 1.0 seed 0, once to build and warm up, then under ``torch.profiler``
through that checkout's ``chip_smoke.trace_solve``, and prints the traced
wall, the device's busy time and the device time of the B2 kernels.
``--root`` names the checkout whose ``src/`` and ``chip_smoke.py`` are
used (default: this one), so that two trees, for example a parent commit
unpacked with ``git archive`` under the ignored ``build/``, are compared
in one call on one card, in turns.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/dense_solve_trace.py [--root DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("dense_solve_trace: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.solver import HeteroLP, LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.scenarios import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_name_and_limit(), flush=True)
    dev = torch.device("cuda:0")
    net = generate("powerlaw", scale=1.0, seed=0, cache=False).network
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    norm = make_engine("kernel", cfg, device=dev).prepare(net).norm
    solver = HeteroLP(LPConfig(backend="dense", use_kernel=True, sigma=1e-4, seed_mode="fixed"),
                      device=dev)
    rounds = solver.run(norm).outer_iters
    t_p, busy_us, by_name = cs.trace_solve(torch, f"dense solve of {root}", lambda: solver.run(norm))
    b2_us = sum(t for name, (t, _) in by_name.items()
                if any(k in name for k in ("lp_round", "split_f", "pad_a")))
    print(f"{root}: {rounds} rounds, traced wall {t_p:.4f} s, device busy {busy_us / 1e3:.3f} ms, "
          f"B2 kernels {b2_us / 1e3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
