#!/usr/bin/env python3
"""B5 ``embedding_bag`` under variants of its kernel, on the card.

Builds scratch copies of ``src/repro_torch/csrc/embedding_bag.cu`` (under
``build/``, which git ignores) with one design choice changed each (rows
in flight per lane, streaming stores, an L2 evict-last policy on the row
loads, a persistent grid), runs the shipped build with 4-byte lanes (the
wrapper's plan forced to the scalar regime, and to scalar id loads for
the wide lookup), and, given ``--parent``, builds that checkout's
``embedding_bag.cu`` with its own C interface (the earlier kernel: one bag
per warp).  Each is checked against the plain version, then timed with
CUDA events on the two lookups of one Wide & Deep ``FULL`` ``serve_bulk``
call (262,144 examples of ``sample_ctr_batch``, seed 0: the deep lookup
of 10,485,760 one-slot bags of D = 32 from the 40,000,000-row table, the
wide lookup of 262,144 bags of 40 slots at D = 1), beside
``F.embedding_bag``, in a loop of launches and with L2 flushed before
each launch.  The runs go forward through the list and then back, so each
variant is timed twice around the others.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/embedding_bag_variants.py [--parent DIR]

``DIR`` is a checkout of an earlier tree, for example ``git archive``
of the parent commit unpacked under ``build/parent``.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = "embedding_bag.cu"
ROWS = "constexpr int kRowsInFlight = 8;"
TILE = "constexpr int kTileIds = 1;"
STREAM = "constexpr bool kStreamStores = true;"
EVICT = "constexpr bool kEvictLast = false;"
PERSIST = "constexpr bool kPersistent = true;"
# (name, source edits, plans forced for the deep and the wide lookup)
VARIANTS = (
    ("shipped", (), None),
    ("1 row in flight", ((ROWS, ROWS.replace("8", "1")),), None),
    ("4 rows in flight", ((ROWS, ROWS.replace("8", "4")),), None),
    ("16 rows in flight, 64-bag tiles",
     ((ROWS, ROWS.replace("8", "16")), (TILE, TILE.replace("1", "2"))), None),
    ("4-byte lanes", (), {"deep": ("scalar", 1, 32), "wide": ("slots", 1, 8)}),
    ("plain stores", ((STREAM, STREAM.replace("true", "false")),), None),
    ("evict-last row loads", ((EVICT, EVICT.replace("false", "true")),), None),
    ("one tile a block", ((PERSIST, PERSIST.replace("true", "false")),), None),
    ("wide: 1 lane a bag", (), {"wide": ("slots", 4, 1)}),
    ("wide: 2 lanes a bag", (), {"wide": ("slots", 4, 2)}),
    ("wide: 8 lanes a bag", (), {"wide": ("slots", 4, 8)}),
)
ITERS = 30  # launches per timing

FORCED = {name: plans for name, _, plans in VARIANTS}


def cold_ms(torch, fn, scrub, iters):
    """Mean device time of ``fn`` with L2 flushed before each launch (as a
    serving call finds it: its matrix products stream far more than L2
    holds), from a CUDA event pair around each launch alone."""
    fn()
    pairs = []
    for i in range(iters):
        scrub.fill_(float(i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose embedding_bag.cu is timed as the parent")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("embedding_bag_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import cells, wide_deep
    from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_bag import BagPlan, embedding_bag_op, embedding_bag_ref, ops
    from repro_torch.models.recsys import WideDeep

    print(cs.smi_name_and_limit(), flush=True)
    started = {name: cs.start_variant(common, SOURCE, edits, f"eb_{i}")
               for i, (name, edits, _) in enumerate(VARIANTS) if edits}
    if args.parent:
        parent_csrc = Path(args.parent).resolve() / "src" / "repro_torch" / "csrc"
        parent_common = SimpleNamespace(CSRC_DIR=parent_csrc, _local_headers=lambda s: [],
                                        find_nvcc=common.find_nvcc, NVCC_FLAGS=common.NVCC_FLAGS)
        started["parent"] = cs.start_variant(parent_common, SOURCE, (), "eb_parent")
    libs = {name: common.load_library(SOURCE) for name, edits, _ in VARIANTS if not edits}
    libs.update({name: cs.finish_variant(common, job) for name, job in started.items()})
    for name, lib in libs.items():  # registers of the f32 instantiations
        lines = lib.log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "_kernelIf" in line:
                kern = line[line.index("bag_") : line.index("_kernelIf") + 16]
                info = [x.split("ptxas info    :")[-1].strip() for x in lines[i + 1 : i + 4]
                        if "registers" in x or "spill" in x]
                print(f"  {name}: {kern}: {'; '.join(info)}")

    dev = torch.device("cuda:0")
    cfg = wide_deep.FULL
    batch = sample_ctr_batch(CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field, seed=0),
                             cells.RECSYS_SHAPES["serve_bulk"]["batch"])
    wd = WideDeep(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():
        wd.wide_table.normal_(0.0, 0.02, generator=torch.Generator(device=dev).manual_seed(1))
    rows = wd.rows(batch["sparse"])
    deep = (wd.table, rows.reshape(-1, 1), torch.ones((rows.numel(), 1), device=dev))
    wide = (wd.wide_table[:, None], rows, torch.ones(rows.shape, device=dev))
    want = {label: embedding_bag_ref(*ops_) for label, ops_ in (("deep", deep), ("wide", wide))}
    outs = {label: torch.empty_like(w) for label, w in want.items()}

    def parent_launch(lib, tab, idx, w, out):
        fn = lib.cdll.embedding_bag_launch
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        common.check_launch("parent embedding_bag", fn(
            tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), idx.shape[0],
            idx.shape[1], tab.shape[1], 0, dev.index, common.stream_handle(dev)))
        return out

    def runner(name, label):
        ops_ = deep if label == "deep" else wide
        out = outs[label]
        if name == "parent":
            return lambda: parent_launch(libs[name], *ops_, out)
        forced = (FORCED[name] or {}).get(label)
        lib = libs[name]

        def run():
            shipped_plan, shipped_load = ops.bag_plan, ops.load_library
            ops.load_library = lambda source: lib
            if forced is not None:
                ops.bag_plan = lambda *a, **k: BagPlan(*forced)
            try:
                return embedding_bag_op(*ops_, out=out)
            finally:
                ops.bag_plan, ops.load_library = shipped_plan, shipped_load
        return run

    names = [v[0] for v in VARIANTS] + (["parent"] if args.parent else [])
    lib_ms = []
    for label, ops_ in (("deep", deep), ("wide", wide)):
        tab, idx, w = ops_
        lib_ms.append(cs.cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
            idx, tab, mode="sum", per_sample_weights=w), iters=ITERS))
    scrub = torch.empty(64 << 20, device=dev)  # 256 MB, five times L2
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        if not times[name]:
            for label in ("deep", "wide"):
                got = runner(name, label)()
                torch.cuda.synchronize()
                cs.check_close(np, f"{name}: {label}", got, want[label], cs.F32_TOL)
                if label == "deep" and not torch.equal(got, want[label]):
                    cs.fail(f"{name}: the deep lookup is not an exact gather")
        times[name].append(tuple(cs.cuda_ms(torch, runner(name, label), iters=ITERS)
                                 for label in ("deep", "wide"))
                           + tuple(cold_ms(torch, runner(name, label), scrub, ITERS)
                                   for label in ("deep", "wide")))
    print(f"  F.embedding_bag: deep {lib_ms[0]:.4f} ms, wide {lib_ms[1]:.4f} ms")
    print("  variant: deep ms (forward / back), wide ms (forward / back); "
          "with L2 flushed before each launch: deep, wide (forward / back)")
    for name in names:
        (d1, w1, cd1, cw1), (d2, w2, cd2, cw2) = times[name]
        print(f"  {name}: deep {d1:.4f} / {d2:.4f}, wide {w1:.4f} / {w2:.4f}; "
              f"flushed: deep {cd1:.4f} / {cd2:.4f}, wide {cw1:.4f} / {cw2:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
