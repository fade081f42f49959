#!/usr/bin/env python3
"""B2 ``lp_round`` under variants of its tile and accumulator, on the card.

``src/repro_torch/csrc/lp_round.cu`` computes ``c·base + A @ F`` as three
TF32 tensor-core products of split operands.  This script builds scratch
copies of it (under ``build/``, which git ignores) with other output-tile
widths (``kBN``, which also sets the ring's depth), with or without the
accumulator folded into a separate f32 register sum after every stage
(``kPromote``), with other register budgets (``setmaxnreg``), and without
the hi·lo and lo·hi products (the planted fault of ``chip_smoke.py``'s f64
gate), and runs each at the LP path's shape: the
fused dense operator of ``powerlaw`` scale 1.0 seed 0, N = S = 4,396.  For
each variant it prints the ``-Xptxas -v`` lines of its product kernel,
max|Δ| against the plain version and against an f64 product (beside the
plain f32 product's), and the CUDA-event time of a round (with the rate of
TF32 products issued and of the tiles the blocks load), beside
``torch.addmm`` with TF32 off.  The runs go forward through the list and
then back, so each variant is timed twice around the others.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/lp_round_variants.py
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TILE = re.compile(r"constexpr int kBN = \d+;")
PROMOTE = re.compile(r"constexpr bool kPromote = \w+;")
CONSUMER_REGS = "setmaxnreg.inc.sync.aligned.u32 232;"
PRODUCER_REGS = "setmaxnreg.dec.sync.aligned.u32 40;"
# (name, kBN, kPromote, consumer registers, producer registers)
VARIANTS = (
    ("kBN 128, promoted", 128, True, 232, 40),
    ("kBN 192, promoted", 192, True, 232, 40),
    ("kBN 192, promoted, 240 registers", 192, True, 240, 24),
    ("kBN 256, not promoted", 256, False, 232, 40),
    ("kBN 128, not promoted", 128, False, 232, 40),
)


def edits(cs, text, bn, promote, consumer, producer):
    """The (old, new) text edits that make a variant of the shipped source."""
    out = [(TILE.search(text).group(0), f"constexpr int kBN = {bn};"),
           (PROMOTE.search(text).group(0), f"constexpr bool kPromote = {str(promote).lower()};")]
    if consumer != 232:
        out += [(CONSUMER_REGS, CONSUMER_REGS.replace("232", str(consumer))),
                (PRODUCER_REGS, PRODUCER_REGS.replace("40", str(producer)))]
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lp_round_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.solver import HeteroLP, LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.kernels import common
    from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref, ops
    from repro_torch.scenarios import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_name_and_limit(), flush=True)
    text = (common.CSRC_DIR / ops.SOURCE).read_text()
    jobs = [(name, edits(cs, text, *knobs)) for name, *knobs in VARIANTS]
    jobs.append(("shipped, one product (planted)", [(line, "") for line in cs.B2_LO_PRODUCTS]))
    shipped_bn = int(TILE.search(text).group(0).split("=")[1].strip(" ;"))
    tile_width = {name: bn for name, bn, *_ in VARIANTS}
    tile_width["shipped, one product (planted)"] = shipped_bn
    started = [(name, cs.start_variant(common, ops.SOURCE, ed, "lp_round_" + str(i)))
               for i, (name, ed) in enumerate(jobs)]
    libs = {}
    for name, job in started:
        libs[name] = cs.finish_variant(common, job)
        lines = libs[name].log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "lp_round_kernel" in line and "IfLb1E" in line:
                info = [x.split("ptxas info    :")[-1].strip() for x in lines[i + 1 : i + 4]
                        if "registers" in x or "spill" in x]
                print(f"  {name}: {'; '.join(info)}")
        flagged = [x.strip() for x in lines if "C7514" in x or "C7508" in x]
        print(f"  {name}: {len(flagged)} wgmma-serialization or setmaxnreg warnings"
              + (f": {flagged[0]}" if flagged else ""), flush=True)

    dev = torch.device("cuda:0")
    net = generate("powerlaw", scale=1.0, seed=0, cache=False).network
    n = s = net.num_nodes
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    norm = make_engine("kernel", cfg, device=dev).prepare(net).norm
    solver = HeteroLP(LPConfig(backend="dense", use_kernel=True, sigma=1e-4, seed_mode="fixed"),
                      device=dev)
    A, _ = solver.operator_arrays(norm)["fused"]
    gen = torch.Generator(device=dev).manual_seed(0)
    F, base = (torch.rand((n, s), generator=gen, device=dev) for _ in range(2))
    c = 0.25
    plain = lp_round_ref(A, F, base, c)
    runs = [("plain", lambda: lp_round_ref(A, F, base, c))]
    for name, lib in libs.items():
        runs.append((name, lambda lib=lib: cs.with_library(
            ops, lib, lambda: lp_round_op(A, F, base, c=c))))
    errs = cs.b2_f64_errors(torch, A, F, base, c, runs)
    print(f"N = S = {n}; max|Δ| vs an f64 product: plain (f32 addmm, TF32 off) "
          f"{errs['plain']:.3e}", flush=True)
    for name, lib in libs.items():
        got = cs.with_library(ops, lib, lambda: lp_round_op(A, F, base, c=c))
        ok = bool(np.allclose(got.cpu().numpy(), plain.cpu().numpy(), **cs.F32_TOL))
        print(f"  {name}: vs plain max|Δ| {float((got - plain).abs().max()):.3e} "
              f"(F32_TOL {'holds' if ok else 'FAILS'}); vs f64 {errs[name]:.3e} = "
              f"{errs[name] / errs['plain']:.2f}x plain (gate {cs.B2_F64_FACTOR:g}x: "
              f"{'holds' if errs[name] <= cs.B2_F64_FACTOR * errs['plain'] else 'fails'})",
              flush=True)
        del got
    ops_issued = 3 * 2.0 * n * n * s

    def tile_bytes(bn):  # every block's k-stages: the A tile and F^T_hi, F^T_lo tiles
        k_stages = -(-(-(-n // 4) * 4) // 32)
        return -(-n // 128) * -(-s // bn) * k_stages * (128 + 2 * bn) * 32 * 4.0

    order = list(libs) + list(libs)[::-1]
    for name in order:
        ms = cs.cuda_ms(torch, lambda: cs.with_library(
            ops, libs[name], lambda: lp_round_op(A, F, base, c=c)), iters=5)
        print(f"  {name}: {ms:.4f} ms per round, {ops_issued / ms / 1e9:.1f} TFLOP/s of "
              f"TF32 products issued, {tile_bytes(tile_width[name]) / ms / 1e9:.2f} TB/s of "
              "tile loads", flush=True)
    lib_ms = cs.cuda_ms(torch, lambda: torch.addmm(base, A, F, beta=c), iters=5)
    print(f"  torch.addmm (TF32 off): {lib_ms:.4f} ms", flush=True)
    Aq, Fq, bq = (x.to(torch.bfloat16) for x in (A, F, base))
    ms = cs.cuda_ms(torch, lambda: lp_round_op(Aq, Fq, bq, c=c), iters=5)
    print(f"  shipped, bf16 (one product): {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
