#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds, the program's and the control's.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 3]

One process: for each seed it makes the inputs, sets the program up, runs
a short window at the cell's own sizes and load, and prints the numbers
its check compares, one JSON line per seed.  ``--control-seeds`` run the
control instead: the program with its own bfloat16 path switched on, the
next precision below the configuration's float32.  The limits in
``perfbench/cells/<name>.json`` are set between the two readings: above
the largest the program gives, below the smallest the control gives.

The benchmark's runs never run the control.  Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import host, spec

    cell = spec.load_cell(ROOT, args.workload)
    host.apply(cell.config)

    import torch

    from perfbench.harness import cells, trace

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        drv = cells.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, "cuda:0", control)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        status = drv.window(args.seconds, trace.Tracer(False))
        e2e = drv.end_to_end()
        numbers = drv.check()
        del drv
        cells._free("cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "setup_s": setup, **status, **e2e,
                          "numbers": {k: (v if v == v and abs(v) != float("inf") else str(v))
                                      for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
