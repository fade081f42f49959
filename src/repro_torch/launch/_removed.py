"""Removal stubs for the retired ``repro_torch.launch.*`` entry points.

The deprecation shims (``python -m repro_torch.launch.solve`` etc.) carried
the pre-RunSpec flag surfaces through one migration window; that window
has closed.  Each retired module now calls :func:`removed_main`, which
prints the migration hint and exits non-zero — loudly, instead of
silently drifting from the unified driver's behavior.

The positional subcommands (``python -m repro_torch solve|serve|scenario|
bench``) keep the legacy flag surfaces and remain supported.
"""

from __future__ import annotations

import sys


def removal_message(name: str) -> str:
    return (
        f"repro_torch.launch.{name} has been removed - use "
        f"`python -m repro_torch run` (DESIGN.md §13) or the "
        f"`python -m repro_torch {name}` subcommand, which keeps the old "
        f"flag surface"
    )


def removed_main(name: str) -> None:
    print(removal_message(name), file=sys.stderr)
    raise SystemExit(2)
