#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic,
its limits and its per-layer metrics are found by name from
``BENCHMARK.json`` (see ``perfbench/harness/spec.py``).  The last line of
standard output is the result, one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.

Exits without a result: 2 when CUDA is missing or fewer cards are visible
than the cell asks for, 3 when a module of JAX or of the JAX package was
loaded by the time the result is made, 4 when the C library refuses a host
setting the cell's configuration states.  The program's CUDA builds stay
in ``build/`` inside the checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, *, device: str = "cuda:0") -> int:
    """``device`` other than a CUDA card skips the look for cards: the CPU
    tests drive the rest of a run through it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import host, spec

    cell = spec.load_cell(ROOT, args.workload)
    try:
        host.apply(cell.config)
    except host.HostSettingRefused as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 4

    import torch

    from perfbench.harness import runner

    on_card = device.startswith("cuda")
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees {have}",
              file=sys.stderr)
        return 2
    try:
        out = runner.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                         device=device, t0=T0)
    except runner.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
