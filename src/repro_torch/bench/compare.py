"""Baseline comparator — the perf gate.

    python -m repro_torch.bench.compare
    python -m repro_torch.bench.compare --timing gate --tolerance 0.30
    python -m repro_torch.bench.compare --baseline benchmarks/baseline.json \
        --candidate BENCH_torch_ci.json

The candidate defaults to ``BENCH_torch_ci.json`` in the working directory
(where the bench pass writes it) and the
baseline to the port's own, ``src/repro_torch/bench/baseline_h100.json``
(a fast pass on an H100, under its own ``host_class``).  The reference's
``benchmarks/baseline.json`` (CPU records) gates the strict metrics only:
its fingerprint never matches a card's.

Gate policy (DESIGN.md §10):

* correctness-derived metrics (each record's ``strict`` list: iteration
  counts, accuracy, backend agreement) hard-fail on any mismatch beyond
  ``--strict-tolerance`` — these are environment-independent;
* wall-time (``stats.median_s``) fails beyond ``--tolerance`` ONLY with
  ``--timing gate`` and when the baseline and candidate environment
  fingerprints match — a baseline recorded on different hardware cannot
  gate wall times, so mismatched environments downgrade timing
  regressions to warnings.  The CLI's default is ``--timing report``:
  the fast pass's cells on a card are launch- and host-bound, and their
  medians move by more than 30 % between passes of unchanged code
  (``PERF.md`` §2), so the findings are printed as warnings and do not
  fail;
* a baseline record missing from the candidate is a coverage regression
  and fails; candidate-only records are reported as new.

Exit codes: 0 pass, 1 regression, 2 baseline missing/unreadable (0 with
``--allow-missing``, so the gate bootstraps before a baseline lands).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Mapping, Optional

from repro_torch.bench.report import FILE_PREFIX, env_fingerprint, load_report
from repro_torch.bench.schema import SchemaError, record_key

#: the port's own baseline: a fast pass on an H100 (``BENCH_torch_ci.json``)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline_h100.json")


@dataclasses.dataclass
class Finding:
    key: str
    kind: str  # strict | timing | missing | error
    metric: str
    baseline: Optional[float]
    candidate: Optional[float]
    detail: str = ""


@dataclasses.dataclass
class CompareResult:
    regressions: List[Finding] = dataclasses.field(default_factory=list)
    warnings: List[Finding] = dataclasses.field(default_factory=list)
    improvements: List[Finding] = dataclasses.field(default_factory=list)
    new_keys: List[str] = dataclasses.field(default_factory=list)
    compared: int = 0
    env_match: bool = True
    timing_gated: bool = True

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _rel_exceeds(candidate: float, baseline: float, tol: float) -> bool:
    """candidate regressed past baseline by more than tol (relative)."""
    scale = max(abs(baseline), 1e-12)
    return (candidate - baseline) / scale > tol


def compare_reports(
    baseline: Mapping[str, object],
    candidate: Mapping[str, object],
    *,
    tolerance: float = 0.30,
    strict_tolerance: float = 0.05,
    gate_timing: bool = True,
) -> CompareResult:
    """Findings of ``candidate`` against ``baseline``; wall-time findings
    are regressions only when ``gate_timing`` and the fingerprints match."""
    res = CompareResult(timing_gated=gate_timing)
    base_env = env_fingerprint(dict(baseline["environment"]))
    cand_env = env_fingerprint(dict(candidate["environment"]))
    res.env_match = base_env == cand_env
    base_recs = {record_key(r): r for r in baseline["records"]}
    cand_recs = {record_key(r): r for r in candidate["records"]}
    res.new_keys = sorted(set(cand_recs) - set(base_recs))

    for key in sorted(base_recs):
        brec = base_recs[key]
        crec = cand_recs.get(key)
        if crec is None:
            detail = "present in baseline, absent from candidate"
            res.regressions.append(
                Finding(key, "missing", "record", None, None, detail)
            )
            continue
        if crec.get("error") is not None:
            detail = f"candidate errored: {crec['error']}"
            res.regressions.append(
                Finding(key, "error", "record", None, None, detail)
            )
            continue
        res.compared += 1

        for metric in brec.get("strict", []):
            b = float(brec["derived"][metric])
            c = float(crec.get("derived", {}).get(metric, float("nan")))
            scale = max(abs(b), 1.0)
            if not (abs(c - b) / scale <= strict_tolerance):
                detail = f"|delta|/max(|base|,1) > {strict_tolerance}"
                res.regressions.append(
                    Finding(key, "strict", metric, b, c, detail)
                )

        b_t = float(brec["stats"]["median_s"])
        c_t = float(crec["stats"]["median_s"])
        if _rel_exceeds(c_t, b_t, tolerance):
            rel = (c_t - b_t) / max(b_t, 1e-12)
            detail = f"+{rel:.0%} vs tolerance {tolerance:.0%}"
            finding = Finding(key, "timing", "median_s", b_t, c_t, detail)
            if res.env_match and gate_timing:
                res.regressions.append(finding)
            else:
                finding.detail += (
                    " (timing reported, not gated)"
                    if res.env_match
                    else " (environment mismatch: warning only)"
                )
                res.warnings.append(finding)
        elif _rel_exceeds(b_t, c_t, tolerance):
            detail = "faster than baseline; consider refreshing it"
            res.improvements.append(
                Finding(key, "timing", "median_s", b_t, c_t, detail)
            )
    return res


def _print_result(res: CompareResult, out=None) -> None:
    out = out if out is not None else sys.stdout  # late-bound: tests capture

    def show(title: str, findings: List[Finding]) -> None:
        if not findings:
            return
        print(f"{title}:", file=out)
        for f in findings:
            b = "-" if f.baseline is None else f"{f.baseline:.6g}"
            c = "-" if f.candidate is None else f"{f.candidate:.6g}"
            line = f"  [{f.kind}] {f.key} {f.metric}: {b} -> {c}  {f.detail}"
            print(line, file=out)

    show("REGRESSIONS", res.regressions)
    show("warnings", res.warnings)
    show("improvements", res.improvements)
    if res.new_keys:
        print(f"new records (not in baseline): {len(res.new_keys)}", file=out)
    if not res.timing_gated and any(f.kind == "timing" for f in res.warnings):
        print(
            "timing: reported, not gated — the fast pass's walls on a card "
            "cannot resolve the tolerance (PERF.md §2); --timing gate fails "
            "on them",
            file=out,
        )
    verdict = "PASS" if res.ok else "FAIL"
    print(
        f"compare: {verdict} — {res.compared} records compared, "
        f"{len(res.regressions)} regressions, {len(res.warnings)} warnings, "
        f"{len(res.improvements)} improvements "
        f"(env_match={res.env_match})",
        file=out,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.bench.compare",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument(
        "--candidate",
        default=None,
        help=f"default: BENCH_{FILE_PREFIX}ci.json in the working directory",
    )
    ap.add_argument(
        "--tolerance",
        type=float,
        default=0.30,
        help="relative wall-time regression allowance",
    )
    ap.add_argument(
        "--timing",
        choices=("report", "gate"),
        default="report",
        help="report wall-time findings as warnings (default) or fail on them",
    )
    ap.add_argument(
        "--strict-tolerance",
        type=float,
        default=0.05,
        help="allowance for correctness-derived metrics",
    )
    ap.add_argument(
        "--allow-missing",
        action="store_true",
        help="exit 0 when the baseline file does not exist",
    )
    ap.add_argument(
        "--json",
        default=None,
        help="also write the comparison summary here",
    )
    args = ap.parse_args(argv)

    candidate_path = args.candidate or f"BENCH_{FILE_PREFIX}ci.json"
    try:
        baseline = load_report(args.baseline)
    except FileNotFoundError:
        msg = f"baseline not found: {args.baseline}"
        if args.allow_missing:
            print(f"compare: PASS (no gate) — {msg}")
            return 0
        print(f"compare: ERROR — {msg}", file=sys.stderr)
        return 2
    except (json.JSONDecodeError, SchemaError, OSError) as e:
        # corrupt/invalid baseline is "unreadable", not "regression" —
        # and never waived by --allow-missing (it needs a human)
        print(
            f"compare: ERROR — unreadable baseline {args.baseline}: {e}",
            file=sys.stderr,
        )
        return 2
    try:
        candidate = load_report(candidate_path)
    except FileNotFoundError:
        print(
            f"compare: ERROR — candidate not found: {candidate_path}",
            file=sys.stderr,
        )
        return 2
    except (json.JSONDecodeError, SchemaError, OSError) as e:
        print(
            f"compare: ERROR — unreadable candidate {candidate_path}: {e}",
            file=sys.stderr,
        )
        return 2

    res = compare_reports(
        baseline,
        candidate,
        tolerance=args.tolerance,
        strict_tolerance=args.strict_tolerance,
        gate_timing=args.timing == "gate",
    )
    _print_result(res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res.to_dict(), f, indent=2)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
