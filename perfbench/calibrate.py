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

The benchmark's runs never run the control.  Needs the cards the cell
asks for.  A cell on k > 1 ranks runs each seed through ``run.py`` in a
process of its own, as the benchmark runs it (its world, NCCL's above
all, is set up once a process), every rank told by ``--control`` whether
it runs the control, and reads the numbers from the result's ``check``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, *, device: str = "cuda:0") -> int:
    """``device`` other than a CUDA card skips the look for cards, as
    ``run.main``'s does."""
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

    from perfbench.harness import cells, runner, trace

    on_card = device.startswith("cuda")
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"calibrate needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    loop, ranges = runner.loop_of(cell)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        head = {"workload": args.workload, "seed": seed, "control": control}
        if cell.chips > 1:
            out = _run_py(["--workload", args.workload, "--seed", str(seed), "--seconds",
                           repr(args.seconds), "--trace", "0"] + ["--control"] * control,
                          device)
            if out is None:
                return 1
            print(json.dumps({**head, "attempted": out["attempted"], "failed": out["failed"],
                              **{k: m["value"] for k, m in out["metrics"].items()},
                              "numbers": {k: c["value"] for k, c in out["check"].items()}}),
                  flush=True)
            continue
        t0 = time.perf_counter()
        drv = loop(cell.config, cell.traffic, seed, device, control)
        if on_card:
            torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        status = drv.window(args.seconds, trace.Tracer(False, ranges))
        e2e = drv.end_to_end()
        numbers = drv.check()
        del drv
        cells._free(device)
        print(json.dumps({**head, "setup_s": setup, **status, **e2e,
                          "numbers": {k: (v if v == v and abs(v) != float("inf") else str(v))
                                      for k, v in numbers.items()}}), flush=True)
    return 0


def _run_py(argv, device):
    """The result of ``run.py`` with ``argv`` on ``device``, run in a new
    process; ``None`` where it gave none (its standard error is this one's)."""
    code = (f"import runpy, sys; sys.exit(runpy.run_path({str(ROOT / 'perfbench' / 'run.py')!r})"
            f"['main']({argv!r}, device={device!r}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    res = subprocess.run([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                         cwd=ROOT, env=env)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        print(f"run.py {' '.join(argv)} exited with {res.returncode}", file=sys.stderr)
        return None
    return json.loads(lines[-1])


if __name__ == "__main__":
    sys.exit(main())
