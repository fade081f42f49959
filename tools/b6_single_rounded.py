#!/usr/bin/env python3
"""What one bf16 rounding of P would cost B6 in accuracy, on the card.

B6's bf16 regimes (``src/repro_torch/csrc/flash_attention.cu``) feed P to
the P.V product as two bf16 terms, ``P_hi`` and ``P_lo``.  This script
builds a scratch copy of the kernel without the ``P_lo`` products (under
``build/``, which git ignores) and runs both the kernel and the copy at
``chip_smoke.FLASH_SHAPES``'s bf16 shapes, printing for each: max|Δ|
against the plain version, the number of values outside B6's one-ulp
gate (``chip_smoke.FLASH_BF16_TOL``) and the CUDA-event time.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/b6_single_rounded.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the P_lo products of the decode tile (mma.sync) and of the prefill tile (wgmma)
LO_PRODUCTS = (
    "        mma_bf16(acc[dt], pl[tt], vb[0], vb[1]);\n",
    "        mma_bf16(acc[dt + 1], pl[tt], vb[2], vb[3]);\n",
    "      wgmma_rs(acc, pl[tt], dv);\n",
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b6_single_rounded: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import gqa_attention_op, gqa_attention_ref, ops

    src = (common.CSRC_DIR / "flash_attention.cu").read_text()
    single = src
    for line in LO_PRODUCTS:
        if line not in single:
            raise SystemExit(f"b6_single_rounded: the kernel no longer has {line.strip()!r}")
        single = single.replace(line, "")
    scratch = ROOT / "build" / "single_rounded"
    scratch.mkdir(parents=True, exist_ok=True)
    (scratch / "flash_attention.cu").write_text(single)
    so = scratch / "flash_attention.so"
    subprocess.run([common.find_nvcc(), *common.NVCC_FLAGS, "-o", str(so),
                    str(scratch / "flash_attention.cu")], check=True, capture_output=True)
    kernels = {"hi/lo P (the kernel)": common.load_library(ops.SOURCE),
               "single-rounded P": common.BuiltLibrary(so, "")}
    print(cs.smi_name_and_limit(), flush=True)

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(14)
    shipped = ops.load_library
    for label, b, hq, hkv, lq, lk, d, window, q_offset, dt in cs.FLASH_SHAPES:
        if dt != "bf16":
            continue
        q = torch.randn((b, lq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((2, b, lk, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = kv[0], kv[1]
        kw = dict(window=window, q_offset=q_offset, layout="blhd")
        want = gqa_attention_ref(q, k, v, chunk=2048, **kw).float()
        for name, lib in kernels.items():
            ops.load_library = lambda source, lib=lib: lib
            try:
                got = gqa_attention_op(q, k, v, **kw).float()
                ms = cs.cuda_ms(torch, lambda: gqa_attention_op(q, k, v, **kw), warmup=1, iters=5)
            finally:
                ops.load_library = shipped
            outside = int((~torch.isclose(got, want, **cs.FLASH_BF16_TOL)).sum())
            print(f"{label}: {name}: max|Δ| {float((got - want).abs().max()):.3e}, {outside} of "
                  f"{got.numel()} values outside rtol=2e-2, atol=1e-5; {ms:.4f} ms", flush=True)
            del got
        del q, kv, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
