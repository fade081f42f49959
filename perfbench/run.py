#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the cards this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic,
its limits and its per-layer metrics are found by name from
``BENCHMARK.json`` (see ``perfbench/harness/spec.py``).  The last line of
standard output is the result, one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.

A cell on ``chips`` k > 1 runs in k processes, one per card: this one is
rank 0 and starts the others as children of this script (``--rank``,
``--world``: see ``perfbench/harness/world.py``).  Only rank 0 prints.

Exits without a result: 2 when CUDA is missing or fewer cards are visible
than the cell asks for, 3 when a module of JAX or of the JAX package was
loaded, in rank 0 by the time the result is made or in another rank by
the end of its part, 4 when the C library refuses a host setting the
cell's configuration states, 5 when a rank of a k-rank cell raised or
exited nonzero (every rank is then killed, and the rank and the end of
its standard error are named) or the run passed its wall-clock limit
(``world.WALL_S``), 6 when the cell's traffic kind is neither the
harness's own nor a file ``perfbench/kinds/<kind>.py``.  The program's
CUDA builds stay in ``build/`` inside the checkout, at fixed paths.
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
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", help=argparse.SUPPRESS)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
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

    from perfbench.harness import runner, world

    run = dict(seed=args.seed, seconds=args.seconds, traced=bool(args.trace), t0=T0,
               control=args.control)
    if args.rank:  # a child of rank 0, which has looked for the cards and the kind
        member = world.join(args.rank, args.world)
        runner.run(cell, device=member.device, member=member, **run)
        member.leave()
        return 0
    try:
        runner.loop_of(cell)
    except spec.UnknownKind as e:
        print(str(e), file=sys.stderr)
        return 6
    on_card = device.startswith("cuda")
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees {have}",
              file=sys.stderr)
        return 2
    try:
        if cell.chips == 1:
            out = runner.run(cell, device=device, **run)
        else:
            out = _lead(cell, device, **run)
    except runner.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _lead(cell, device, *, seed, seconds, traced, t0, control):
    """Rank 0 of a k-rank cell: start the other ranks, run with them, and
    see each of them end.  ``control`` (``--control``, which only
    ``calibrate.py`` passes) runs the control on every rank."""
    import traceback

    from perfbench.harness import runner, world

    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", repr(seconds),
            "--trace", str(int(traced))] + (["--control"] if control else [])
    ranks = world.Ranks(Path(__file__).resolve(), argv, cell.chips, device, t0)
    try:
        member = world.join(0, ranks.dir)
        out = runner.run(cell, device=member.device, member=member, seed=seed,
                         seconds=seconds, traced=traced, t0=t0, control=control)
    except runner.ForbiddenModules:
        member.leave()
        ranks.finish()
        raise
    except Exception:
        ranks.fail(traceback.format_exc())  # ends this process
    member.leave()
    ranks.finish()
    return out


if __name__ == "__main__":
    sys.exit(main())
