"""Shared bench-pass driver: one implementation behind every entry point.

``python -m repro_torch bench``, ``python -m repro_torch run`` with a
``bench`` section (or ``--bench``), and ``Session.bench()`` all execute a
benchmark pass through :func:`run_bench` — same suite registration, same
report writing, same failure semantics (DESIGN.md §10).

The suites are modules of this package (``repro_torch.bench.suites``
plus the two matrix suites); importing them registers them.  The
reference's ``lp_on_graph`` and ``roofline`` suites need modules not
ported yet: a pass over every suite prints one
``skipped <suite>: not ported (ROADMAP A.n)`` line for each, and naming
one in ``only`` raises the port's ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional

#: reference suites this package lacks -> the ROADMAP.md queue item they wait for
NOT_PORTED_SUITES = {
    "lp_on_graph": "A.9.4",  # its GCN cell trains
    "roofline": "A.9.5",  # the dry-run census
}


@dataclasses.dataclass
class BenchOutcome:
    """What a pass produced: suites run, records written, failures."""

    label: str
    suites: List[str]
    records: int
    failures: int
    paths: List[str]


def import_suite_modules() -> None:
    """Import every suite module (registration is an import-time side
    effect) plus the two matrix suites."""
    import repro_torch.bench.matrix as bench_matrix
    import repro_torch.bench.suites.fig34_parallelism  # noqa: F401
    import repro_torch.bench.suites.kernel_variants  # noqa: F401
    import repro_torch.bench.suites.kernels  # noqa: F401
    import repro_torch.bench.suites.serve  # noqa: F401
    import repro_torch.bench.suites.table2_cv  # noqa: F401
    import repro_torch.bench.suites.table34_deleted  # noqa: F401
    import repro_torch.bench.suites.table56_scaling  # noqa: F401
    import repro_torch.bench.suites.table7_sigma  # noqa: F401

    bench_matrix.register()


def refuse_unported(only: Optional[List[str]]) -> None:
    """Raise ``NotImplementedError`` naming the queue item of the first
    suite in ``only`` that is not ported yet."""
    from repro_torch.api.session import not_ported

    for name in only or ():
        if name in NOT_PORTED_SUITES:
            raise not_ported(f"the {name} suite", NOT_PORTED_SUITES[name])


def run_bench(
    *,
    fast: bool = True,
    only: Optional[List[str]] = None,
    label: Optional[str] = None,
    write: bool = True,
    echo: Optional[Callable[[str], None]] = None,
    device=None,
) -> BenchOutcome:
    """Run the registered suites on ``device`` (``None``: ``cuda:0``);
    write ``BENCH_torch_<label>.json`` + ``results/``.

    Raises ``NotImplementedError`` naming the queue item when ``only``
    names a suite that is not ported yet, before anything runs.
    """
    import torch

    from repro_torch.bench.registry import run_suites
    from repro_torch.bench.report import BenchReport, environment_info
    from repro_torch.device import resolve_device

    refuse_unported(only)
    dev = resolve_device(device)
    import_suite_modules()

    resolved = label or ("ci" if fast else "full")
    report = BenchReport(resolved, environment=environment_info(dev))
    if echo:
        echo("name,us_per_call,derived")
    if not only:
        for name, item in NOT_PORTED_SUITES.items():
            print(f"skipped {name}: not ported (ROADMAP {item})", flush=True)
    # the card the suites run on is the current one: an unsynchronized
    # result is waited for on it (timing._default_sync)
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with on_card:
        failures = run_suites(report, only=only, fast=fast, echo=echo, device=dev)
    paths: List[str] = []
    if write:
        paths = report.write()
        if echo:
            for p in paths:
                echo(f"wrote {p}")
    return BenchOutcome(
        label=resolved,
        suites=report.suites,
        records=len(report.records),
        failures=failures,
        paths=paths,
    )
