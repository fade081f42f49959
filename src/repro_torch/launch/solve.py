"""REMOVED entry point — see :mod:`repro_torch.launch._removed`.

``python -m repro_torch.launch.solve`` was a deprecation shim over the unified
driver; the migration window has closed.  Use ``python -m repro_torch run``
(RunSpec, DESIGN.md §13) or ``python -m repro_torch solve`` (legacy flags).
"""

from __future__ import annotations

from repro_torch.launch._removed import removed_main


def main() -> None:
    removed_main("solve")


if __name__ == "__main__":
    main()
