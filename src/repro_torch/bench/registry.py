"""Suite registry: every benchmark registers itself as a named,
parameterized case so one driver can run any subset with one timing and
reporting discipline.

A suite function has signature ``fn(fast: bool, device) ->
List[BenchRecord]``: ``device`` is the ``torch.device`` the pass runs on
(the card unless the caller asked for the CPU).  The suite modules under
``repro_torch.bench.suites`` call :func:`register_suite` at import time;
``repro_torch.bench.driver`` imports them, then drives the registry.
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.bench.report import BenchReport, legacy_csv_line
from repro_torch.bench.schema import BenchRecord

SuiteFn = Callable[[bool, object], List[BenchRecord]]

_REGISTRY: Dict[str, "BenchSuite"] = {}


@dataclasses.dataclass(frozen=True)
class BenchSuite:
    name: str
    fn: SuiteFn
    description: str = ""
    tags: Tuple[str, ...] = ()


def register_suite(
    name: str,
    *,
    description: str = "",
    tags: Sequence[str] = (),
) -> Callable[[SuiteFn], SuiteFn]:
    """Decorator: ``@register_suite("table7_sigma")`` on a suite function."""

    def deco(fn: SuiteFn) -> SuiteFn:
        if name in _REGISTRY and _REGISTRY[name].fn is not fn:
            raise ValueError(f"suite {name!r} already registered")
        _REGISTRY[name] = BenchSuite(
            name=name, fn=fn, description=description, tags=tuple(tags)
        )
        return fn

    return deco


def get_suite(name: str) -> BenchSuite:
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown suite {name!r}; registered: {known}")
    return _REGISTRY[name]


def all_suites() -> List[BenchSuite]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def run_suites(
    report: BenchReport,
    *,
    only: Optional[Sequence[str]] = None,
    fast: bool = True,
    echo: Optional[Callable[[str], None]] = None,
    device=None,
) -> int:
    """Run registered suites on ``device`` into ``report``; returns the
    failure count.

    A suite that raises is recorded via ``report.add_error`` and does NOT
    abort the remaining suites — but the nonzero return propagates to the
    driver's exit code (no swallowed failures).
    """
    names = list(only) if only else [s.name for s in all_suites()]
    failures = 0
    for name in names:
        suite = get_suite(name)
        try:
            records = suite.fn(fast, device)
            # inside the try: a suite emitting a duplicate record key is a
            # suite bug and must not abort the remaining suites
            for rec in records:
                report.add(rec)
                if echo:
                    echo(legacy_csv_line(rec))
                if rec.error is not None:
                    failures += 1
        except Exception as e:  # noqa: BLE001 - isolate suites, fail driver
            failures += 1
            report.add_error(name, f"{type(e).__name__}: {e}")
            if echo:
                echo(f"{name}: ERROR {type(e).__name__}: {e}")
            traceback.print_exc()
    return failures
