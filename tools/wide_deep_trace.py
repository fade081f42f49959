#!/usr/bin/env python3
"""Wide & Deep serving of ``chip_smoke.py``'s phase 10 on the card: one
``serve_bulk`` call traced, and the walls of ``serve_p99`` and
``retrieval_cand`` calls.

Builds Wide & Deep ``FULL`` on the card (random weights from seed 0; the
reference's zero-initialised wide table drawn from seed 1) and samples
the batches of ``sample_ctr_batch`` (seed 0).  Serves ``serve_bulk``
(262,144 examples) once to build and warm up, then traces one call under
``torch.profiler`` through that checkout's ``chip_smoke.trace_solve`` and
prints the traced wall, the device's busy time and the device time of the
``embedding_bag`` kernels, of the concatenation of the MLP input, of the
matrix products and of the host-to-device copies.  Then it times 50
``serve_p99`` calls (512 examples) and 50 ``retrieval_cand`` calls (one
query against 1,000,448 candidates), each ended by a synchronize, and
prints their median and least walls.  ``--root`` names the checkout whose
``src/`` and ``chip_smoke.py`` are used (default: this one), so that two
trees, for example a parent commit unpacked with ``git archive`` under
the ignored ``build/``, are compared in one call on one card, in turns.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/wide_deep_trace.py [--root DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

GROUPS = {  # device-time groups, by substring of the kernel or copy name
    "embedding_bag": ("bag_",),
    "concatenation": ("Cat",),
    "matrix products": ("gemm", "Gemm", "xmma"),
    "host-to-device copies": ("HtoD",),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    if not torch.cuda.is_available():
        print("wide_deep_trace: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import cells, wide_deep
    from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
    from repro_torch.models.recsys import WideDeep, make_retrieval_scorer, make_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_name_and_limit(), flush=True)
    dev = torch.device("cuda:0")
    cfg = wide_deep.FULL
    dcfg = CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field, seed=0)
    batches = {name: sample_ctr_batch(dcfg, cells.RECSYS_SHAPES[name]["batch"])
               for name in ("serve_p99", "serve_bulk", "retrieval_cand")}
    wd = WideDeep(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():
        wd.wide_table.normal_(0.0, 0.02, generator=torch.Generator(device=dev).manual_seed(1))
    serve, score = make_serve(wd), make_retrieval_scorer(wd)
    n_cand = cells.pad512(cells.RECSYS_SHAPES["retrieval_cand"]["n_candidates"])
    cand = torch.rand((n_cand, cfg.mlp_dims[-1]), generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    bulk, p99, q = (batches[name] for name in ("serve_bulk", "serve_p99", "retrieval_cand"))
    call = lambda: serve(bulk["sparse"], bulk["dense"])  # noqa: E731
    call()
    t_p, busy_us, by_name = cs.trace_solve(torch, f"serve_bulk of {root}", call)
    ms = {group: sum(t for name, (t, _) in by_name.items() if any(k in name for k in keys)) / 1e3
          for group, keys in GROUPS.items()}
    parts = ", ".join(f"{group} {t:.3f} ms" for group, t in ms.items())
    print(f"{root}: traced wall {t_p:.4f} s, device busy {busy_us / 1e3:.3f} ms; {parts}",
          flush=True)
    for name, fn in (("serve_p99", lambda: serve(p99["sparse"], p99["dense"])),
                     ("retrieval_cand", lambda: score(q["sparse"], q["dense"], cand))):
        fn()
        cs.trace_solve(torch, f"{name} of {root}", fn)
        walls = sorted(t * 1e3 for t in cs.wall_s(torch, fn, iters=50))
        print(f"{root}: {name} wall median {walls[len(walls) // 2]:.4f} ms, "
              f"least {walls[0]:.4f} ms (50 calls)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
