#!/usr/bin/env python3
"""B1 and B3 under variants of their shared inner loop, on the card.

The round kernels ``csr_round_residual`` (B1) and ``csr_round`` (B3)
share ``src/repro_torch/csrc/csr_round_common.cuh``.  This script builds
scratch copies of both sources (under ``build/``, which git ignores) with
other gathers in flight per warp (``kDepth`` in the header) and warps per
block (each source's ``kMaxWarps``, which also sets the register budget
through ``__launch_bounds__``), and times each variant at several block sizes
(``ops._SLOTS_PER_BLOCK``), and B3 with the header's running row sum in
place of its compensated one (``kCompensated``), on the LP path's shapes: one full B1 round over
the fused plan of ``powerlaw`` scale 1.0 seed 0 and one full B3 round over
its legacy layout, S = 4,396 columns, beside cuSPARSE (``torch.addmm``
with a CSR operator).  Every variant is first checked against the plain
version; the runs go forward through the list and then back, so each
variant is timed twice around the others.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/csr_round_variants.py
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DEPTH = "  static constexpr int kDepth = 8;\n"
WARPS = {"csr_round_residual.cu": "constexpr int kMaxWarps = 16;",
         "csr_round.cu": "constexpr int kMaxWarps = 8;"}
COMPENSATED = "launch<T, T, false, kMaxWarps, true>"  # B3's launch in csr_round.cu
# (name, gathers in flight, B1's warps per block, B3's, slots per block,
#  B3's compensated row sum)
VARIANTS = (
    ("shipped", 8, 16, 8, 2048, True),
    ("slots 1024", 8, 16, 8, 1024, True),
    ("slots 4096", 8, 16, 8, 4096, True),
    ("depth 4", 4, 16, 8, 2048, True),
    ("8 warps", 8, 8, 8, 2048, True),
    ("16 warps", 8, 16, 16, 2048, True),
    ("32 warps", 8, 32, 32, 2048, True),
    ("B3 running sum", 8, 16, 8, 2048, False),
)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("csr_round_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.solver import LPConfig
    from repro_torch.engine import make_engine
    from repro_torch.kernels import common
    from repro_torch.kernels.segment_reduce import (
        csr_round_op,
        csr_round_ref,
        csr_round_residual_op,
        csr_round_residual_ref,
        ops,
    )
    from repro_torch.scenarios import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_name_and_limit(), flush=True)
    texts = {name: (common.CSRC_DIR / name).read_text()
             for name in ("csr_round_common.cuh", *WARPS)}
    for name, line in (("csr_round_common.cuh", DEPTH), *WARPS.items(),
                       ("csr_round.cu", COMPENSATED)):
        if line not in texts[name]:
            raise SystemExit(f"csr_round_variants: {name} no longer has {line.strip()!r}")
    sources = (ops.SOURCE, ops.ROUND_SOURCE)
    warps_of = {ops.SOURCE: 0, ops.ROUND_SOURCE: 1}
    csrc, build_dir = common.CSRC_DIR, common.BUILD_DIR
    libs = {}
    for key in sorted({(d, w1, w3, comp) for _, d, w1, w3, _, comp in VARIANTS}):
        depth = key[0]
        scratch = ROOT / "build" / "csr_round_variants" / "d{}b1w{}b3w{}c{:d}".format(*key)
        (scratch / "csrc").mkdir(parents=True, exist_ok=True)
        (scratch / "csrc" / "csr_round_common.cuh").write_text(texts["csr_round_common.cuh"].replace(
            DEPTH, DEPTH.replace("8", str(depth))))
        for src in sources:
            line = WARPS[src]
            warps = key[1 + warps_of[src]]
            text = texts[src].replace(line, f"constexpr int kMaxWarps = {warps};")
            if not key[3]:
                text = text.replace(COMPENSATED, COMPENSATED.replace("true", "false"))
            (scratch / "csrc" / src).write_text(text)
        common.CSRC_DIR, common.BUILD_DIR = scratch / "csrc", scratch / "out"
        common._LIBS.clear()
        libs[key] = common.build_all(list(sources))
        for src, lib in libs[key].items():
            warps = key[1 + warps_of[src]]
            lines = lib.log.splitlines()
            for i, line in enumerate(lines):  # the f32, 4-column instantiation
                if "Compiling entry" in line and "IffLi4E" in line:
                    info = [x.split("ptxas info    :")[-1].strip() for x in lines[i + 1 : i + 4]
                            if "registers" in x or "spill" in x]
                    print(f"  depth {depth}, {warps} warps, {src} f32: {'; '.join(info)}")
    common.CSRC_DIR, common.BUILD_DIR = csrc, build_dir
    common._LIBS.clear()

    dev = torch.device("cuda:0")
    net = generate("powerlaw", scale=1.0, seed=0, cache=False).network
    n = s = net.num_nodes
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    plan, _, _ = make_engine("kernel", cfg, device=dev).prepare(net).payload.plan
    legacy, _ = make_engine("kernel", cfg, device=dev, fused_superstep=False).prepare(
        net).payload.fused
    gen = torch.Generator(device=dev).manual_seed(0)
    F, base, prev = (torch.rand((n, s), generator=gen, device=dev) for _ in range(3))
    c = 0.25
    offs = np.cumsum([0] + [int(nb.shape[0]) for nb, _, _ in plan])
    rows = [slice(int(offs[i]), int(offs[i + 1])) for i in range(len(plan))]
    lbase = [base[r] for r, _, _, _ in legacy]
    loffs = np.cumsum([0] + [int(nb.shape[0]) for _, nb, _, _ in legacy])
    lrows = [slice(int(loffs[i]), int(loffs[i + 1])) for i in range(len(legacy))]
    out, lout = torch.empty_like(F), torch.empty_like(F)

    def b1_round():
        for sl, (nbr, wgt, live) in zip(rows, plan):
            csr_round_residual_op(nbr, wgt, F, base[sl], prev[sl], c=c, out=out[sl], live=live)
        return out

    def b3_round():
        for sl, b, (_, nbr, wgt, live) in zip(lrows, lbase, legacy):
            csr_round_op(nbr, wgt, F, b, c=c, out=lout[sl], live=live)
        return lout

    want1 = torch.cat([csr_round_residual_ref(nbr, wgt, F, base[sl], prev[sl], c)[0]
                       for sl, (nbr, wgt, _) in zip(rows, plan)])
    want3 = torch.cat([csr_round_ref(nbr, wgt, F, b, c)
                       for b, (_, nbr, wgt, _) in zip(lbase, legacy)])

    def coo(nbr, wgt, row0=0):
        keep = wgt != 0
        return torch.nonzero(keep)[:, 0] + row0, nbr[keep].long(), wgt[keep]

    def csr(parts, m):
        idx = torch.stack([torch.cat([r for r, _, _ in parts]), torch.cat([k for _, k, _ in parts])])
        vals = torch.cat([v for _, _, v in parts])
        return torch.sparse_coo_tensor(idx, vals, (m, n), check_invariants=True).coalesce().to_sparse_csr()

    A = csr([coo(nbr, wgt, int(offs[i])) for i, (nbr, wgt, _) in enumerate(plan)], n)
    lcsr = [csr([coo(nbr, wgt)], nbr.shape[0]) for _, nbr, wgt, _ in legacy]
    b1_lib = cs.cuda_ms(torch, lambda: torch.addmm(base, A, F, beta=c))
    b3_lib = cs.cuda_ms(torch, lambda: [torch.addmm(b, a, F, beta=c) for b, a in zip(lbase, lcsr)])
    print(f"  cuSPARSE: B1 round {b1_lib:.4f} ms, B3 round (x{len(lcsr)}) {b3_lib:.4f} ms")

    slots = ops._SLOTS_PER_BLOCK
    times = {name: [] for name, *_ in VARIANTS}
    for name, depth, w1, w3, spb, comp in VARIANTS + VARIANTS[::-1]:
        common._LIBS.clear()
        common._LIBS.update(libs[depth, w1, w3, comp])
        ops._SLOTS_PER_BLOCK = spb
        if not times[name]:
            cs.check_close(np, f"{name}: B1 round", b1_round(), want1, cs.F32_TOL)
            cs.check_close(np, f"{name}: B3 round", b3_round(), want3, cs.F32_TOL)
        times[name].append((cs.cuda_ms(torch, b1_round), cs.cuda_ms(torch, b3_round)))
    ops._SLOTS_PER_BLOCK = slots
    common._LIBS.clear()
    print("  variant: gathers in flight, warps per block (B1, B3), slots per block, B3 "
          "compensated: B1 round ms (two runs), B3 round ms (two runs)")
    for name, depth, w1, w3, spb, comp in VARIANTS:
        (a1, a3), (b1, b3) = times[name]
        print(f"  {name}: {depth}, ({w1}, {w3}), {spb}, {comp}: B1 {a1:.4f} / {b1:.4f}, "
              f"B3 {a3:.4f} / {b3:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
