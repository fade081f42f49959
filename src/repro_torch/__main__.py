"""``python -m repro_torch`` — the unified driver (DESIGN.md §13).

    python -m repro_torch run examples/specs/quickstart_run.json --device cpu
    python -m repro_torch run --network scenario:powerlaw --scale 0.02 --eval recovery
    python -m repro_torch solve|serve|scenario ...   # deprecation shims

Every subcommand that runs a solve takes ``--device`` (default ``cuda``,
which raises without CUDA; ``cpu`` runs on the CPU).
"""

import sys

from repro_torch.launch.cli import main

if __name__ == "__main__":
    sys.exit(main())
