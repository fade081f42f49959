"""The port's bench harness (``repro_torch.bench``) vs the reference's
(``repro.bench``, ``tests/test_bench_harness.py``).

Every test of the reference's harness file runs here against the port's
modules, with the port's three documented differences: a suite takes
``(fast, device)``, the report is ``BENCH_torch_<label>.json``, and the
backend matrix iterates the port's registry (the reference's keys,
``sharded`` fanned out per rank count and run when the world has that
many ranks).  Beyond them: the same injected
clock gives equal ``TimingStats`` in both packages, a report written by
either package validates under the other's schema, ``compare``'s CLI
gives the same exit code in both packages for each baseline/candidate
pair, the H100 peak tables, the environment fingerprint, and
``repro_torch.bench`` importing with JAX blocked.  The ``gpu`` tests
check the CUDA-event timer and the ``kernels`` suite's ``cuda`` records
on a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.bench as rb
import repro.bench.compare as rcompare
import repro.bench.timing as rtiming
from repro_torch.bench import (
    SCHEMA_VERSION,
    BenchRecord,
    BenchReport,
    SchemaError,
    record_key,
    register_suite,
    stats_from_samples,
    time_callable,
    time_cuda_events,
    validate_record,
    validate_report,
)
from repro_torch.bench import roofline
from repro_torch.bench.compare import compare_reports
from repro_torch.bench.compare import main as compare_main
from repro_torch.bench.matrix import BackendSpec, expand_matrix, lp_backend_specs
from repro_torch.bench.registry import run_suites
from repro_torch.bench.report import env_fingerprint, environment_info, legacy_csv_line, load_report
from repro_torch.bench.timing import derived_throughput

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
class FakeClock:
    """Scripted clock: each call returns the next scheduled instant."""

    def __init__(self, deltas):
        self.t = 0.0
        self.deltas = list(deltas)
        self.calls = 0

    def __call__(self):
        v = self.t
        self.calls += 1
        if self.deltas:
            self.t += self.deltas.pop(0)
        return v


def _clock_deltas(durations=(1.0, 2.0, 3.0, 4.0, 5.0)):
    deltas = []
    for d in durations:
        deltas += [d, 0.0]
    return deltas


def test_time_callable_deterministic_with_injected_clock():
    # 5 measured reps with durations 1,2,3,4,5 (clock advances once per
    # call: start->stop advance = duration, stop->next-start advance = 0)
    clock = FakeClock(_clock_deltas())
    calls = {"n": 0}

    def fn():
        calls["n"] += 1

    stats = time_callable(fn, warmup=2, repeats=5, clock=clock, sync=lambda v: v)
    assert calls["n"] == 7  # 2 warmup + 5 measured
    assert stats.repeats == 5 and stats.warmup == 2
    assert stats.median_s == 3.0
    assert stats.min_s == 1.0 and stats.max_s == 5.0
    assert stats.mean_s == 3.0
    assert stats.p10_s == pytest.approx(1.4)
    assert stats.p90_s == pytest.approx(4.6)


@pytest.mark.parametrize("durations", [(1.0, 2.0, 3.0, 4.0, 5.0), (0.3, 0.1, 0.2), (7.5,)])
def test_injected_clock_gives_equal_stats_in_both_packages(durations):
    got = time_callable(lambda: None, warmup=1, repeats=len(durations),
                        clock=FakeClock(_clock_deltas(durations)), sync=lambda v: v)
    want = rtiming.time_callable(lambda: None, warmup=1, repeats=len(durations),
                                 clock=FakeClock(_clock_deltas(durations)), sync=lambda v: v)
    assert got.to_dict() == want.to_dict()
    assert stats_from_samples(durations).to_dict() == rtiming.stats_from_samples(durations).to_dict()


def test_time_callable_rejects_zero_repeats():
    with pytest.raises(ValueError):
        time_callable(lambda: None, repeats=0)


def test_default_sync_passes_cpu_values_through():
    """On the CPU the default sync waits for nothing and returns the
    value (CUDA is never initialised by it)."""
    from repro_torch.bench.timing import _default_sync

    value = [torch.ones(2), {"a": torch.zeros(1)}, 3]
    assert _default_sync(value) is value
    stats = time_callable(lambda: torch.ones(4) * 2, warmup=1, repeats=2)
    assert stats.repeats == 2 and stats.min_s >= 0.0


def test_time_cuda_events_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        time_cuda_events(lambda: None, "cpu")


def test_stats_from_samples_single_sample_and_roundtrip():
    s = stats_from_samples([0.25])
    assert s.median_s == s.min_s == s.max_s == 0.25
    assert type(s).from_dict(s.to_dict()) == s
    with pytest.raises(ValueError):
        stats_from_samples([])


def test_derived_throughput_uses_median_and_supersteps():
    s = stats_from_samples([2.0])
    d = derived_throughput(s, edges=100, supersteps=10, queries=4, flops=2e9)
    assert d["edges_per_s"] == pytest.approx(100 * 10 / 2.0)
    assert d["supersteps_per_s"] == pytest.approx(5.0)
    assert d["qps"] == pytest.approx(2.0)
    assert d["gflops"] == pytest.approx(1.0)
    assert d == rtiming.derived_throughput(s, edges=100, supersteps=10, queries=4, flops=2e9)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------
def _record(
    name="case",
    suite="suite",
    backend="dense",
    median=1.0,
    derived=None,
    strict=(),
    error=None,
):
    stats = {}
    if error is None:
        stats = stats_from_samples([median]).to_dict()
    return {
        "suite": suite,
        "name": name,
        "backend": backend,
        "params": {"n": 8},
        "stats": stats,
        "derived": dict(derived or {}),
        "strict": list(strict),
        **({"error": error} if error is not None else {}),
    }


def _report(records, env=None, label="ci"):
    environment = {
        "platform": "linux",
        "machine": "x86_64",
        "backend": "cpu",
        "device_kind": "cpu",
        "device_count": 1,
    }
    environment.update(env or {})
    return {
        "schema_version": SCHEMA_VERSION,
        "label": label,
        "created_unix": 1_000.0,
        "environment": environment,
        "records": list(records),
    }


def test_record_roundtrip_and_key():
    rec = BenchRecord(
        suite="lp_matrix",
        name="dhlp2_dense",
        backend="dense",
        params={"alg": "dhlp2"},
        stats=stats_from_samples([0.5]).to_dict(),
        derived={"outer_iters": 13.0},
        strict=["outer_iters"],
    )
    d = rec.to_dict()
    validate_record(d)
    assert "error" not in d
    assert BenchRecord.from_dict(d) == rec
    assert record_key(rec) == "lp_matrix/dhlp2_dense@dense"
    assert record_key(d) == record_key(rec)
    assert rb.record_key(d) == record_key(d)
    assert rb.BenchRecord.from_dict(d).to_dict() == d


MUTATIONS = [
    lambda d: d.pop("suite"),
    lambda d: d.__setitem__("name", ""),
    lambda d: d["stats"].pop("median_s"),
    lambda d: d["stats"].__setitem__("repeats", 0),
    lambda d: d["stats"].__setitem__("median_s", 99.0),  # > max_s
    lambda d: d.__setitem__("strict", ["not_in_derived"]),
    lambda d: d.__setitem__("stats", {}),  # no stats and no error
]


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_record_validation_rejects(mutate):
    d = _record(derived={"x": 1.0})
    mutate(d)
    with pytest.raises(SchemaError):
        validate_record(d)
    with pytest.raises(rb.SchemaError):  # the reference rejects it too
        rb.validate_record(d)


def test_error_record_is_valid_without_stats():
    d = _record(error="boom")
    d["stats"] = {}
    validate_record(d)
    assert legacy_csv_line(d).endswith("error=boom")


def test_report_validation_duplicate_keys_and_version():
    doc = _report([_record(), _record()])
    with pytest.raises(SchemaError, match="duplicate"):
        validate_report(doc)
    doc = _report([_record()])
    doc["schema_version"] = 999
    with pytest.raises(SchemaError, match="schema_version"):
        validate_report(doc)
    validate_report(_report([_record()]))


# ---------------------------------------------------------------------------
# report writing
# ---------------------------------------------------------------------------
def test_bench_report_write_and_load(tmp_path):
    report = BenchReport("ci", environment=_report([])["environment"])
    report.add(BenchRecord.from_dict(_record(name="a", derived={"m": 1.0})))
    report.add(BenchRecord.from_dict(_record(name="b")))
    with pytest.raises(ValueError, match="duplicate"):
        report.add(BenchRecord.from_dict(_record(name="a")))
    paths = report.write(str(tmp_path))
    # the port's name, so neither package overwrites the other's BENCH_ci.json
    assert paths[0] == str(tmp_path / "BENCH_torch_ci.json")
    assert (tmp_path / "results").is_dir()
    assert Path(paths[1]).name.startswith("torch_ci_")
    doc = load_report(paths[0])
    assert doc["label"] == "ci"
    assert len(doc["records"]) == 2
    assert report.suites == ["suite"]


def test_report_write_never_leaves_the_working_directory(tmp_path, monkeypatch):
    """A checkout inside another repository (a ``.git`` above it) still
    gets its report in the working directory, and ``compare``'s default
    candidate is read from there."""
    (tmp_path / ".git").mkdir()
    cwd = tmp_path / "checkout" / "sub"
    cwd.mkdir(parents=True)
    monkeypatch.chdir(cwd)
    report = BenchReport("ci", environment=_report([])["environment"])
    report.add(BenchRecord.from_dict(_record(name="a")))
    paths = report.write()
    assert [Path(p).parent for p in paths] == [cwd, cwd / "results"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [".git", "checkout"]
    assert compare_main(["--baseline", paths[0]]) == 0


def test_reports_validate_under_the_other_package(tmp_path):
    """A report written by either package loads under the other's
    ``load_report`` (its schema), records and all."""
    env = _report([])["environment"]
    recs = [_record(name="a", derived={"m": 1.0}, strict=["m"]), _record(name="b", error="x")]
    mine = BenchReport("ci", environment=dict(env, **environment_info("cpu")))
    theirs = rb.BenchReport("ci", environment=dict(env))
    for r in recs:
        mine.add(BenchRecord.from_dict(r))
        theirs.add(rb.BenchRecord.from_dict(r))
    p_mine = mine.write(str(tmp_path / "t"))[0]
    p_theirs = theirs.write(str(tmp_path / "r"))[0]
    assert Path(p_theirs).name == "BENCH_ci.json" and Path(p_mine).name == "BENCH_torch_ci.json"
    got = rb.load_report(p_mine)  # the reference's schema gate
    want = load_report(p_theirs)  # the port's
    assert got["records"] == want["records"]
    validate_report(rb.load_report(p_theirs))
    rb.validate_report(load_report(p_mine))
    # the reference's committed CPU baseline is a valid port report
    validate_report(json.loads((ROOT / "benchmarks" / "baseline.json").read_text()))


def test_environment_info_names_the_device_and_gates_timing():
    env = environment_info("cpu")
    for key in ("platform", "machine", "backend", "device_kind", "device_count"):
        assert key in env  # the schema's required fields
    assert env["backend"] == env["device_kind"] == "cpu"
    assert env["torch_version"] == torch.__version__
    card = dict(env, backend="cuda", device_kind="NVIDIA H100 80GB HBM3",
                compute_capability="9.0", power_limit="NVIDIA H100 80GB HBM3, 700.00 W")
    lower = dict(card, power_limit="NVIDIA H100 80GB HBM3, 500.00 W")
    assert env_fingerprint(card) != env_fingerprint(lower)
    assert env_fingerprint(card) != env_fingerprint(dict(card, compute_capability="8.0"))
    assert env_fingerprint(card) == env_fingerprint(dict(card, sm_count=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            environment_info()  # the card unless the CPU is asked for


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@pytest.fixture
def scratch_registry():
    """The suites a test registers leave the registry with it: a later
    module in the same worker (``test_torch_bench_suites.py`` runs every
    registered suite) must not find them."""
    from repro_torch.bench import registry

    saved = dict(registry._REGISTRY)
    yield
    registry._REGISTRY.clear()
    registry._REGISTRY.update(saved)


@pytest.mark.usefixtures("scratch_registry")
def test_registry_runs_suites_and_propagates_failures():
    @register_suite("_test_ok", description="test-only")
    def ok(fast, device):
        return [BenchRecord.from_dict(_record(suite="_test_ok", name="x"))]

    @register_suite("_test_boom", description="test-only")
    def boom(fast, device):
        raise RuntimeError("kaput")

    report = BenchReport("t", environment=_report([])["environment"])
    failures = run_suites(report, only=["_test_ok", "_test_boom"], fast=True)
    assert failures == 1
    assert [r.name for r in report.records] == ["x"]
    assert report.errors and "kaput" in report.errors[0]["error"]
    # error records inside a suite also count as failures
    @register_suite("_test_errrec", description="test-only")
    def errrec(fast, device):
        return [
            BenchRecord.from_dict(
                _record(suite="_test_errrec", name="y", error="bad")
            )
        ]

    report2 = BenchReport("t2", environment=_report([])["environment"])
    assert run_suites(report2, only=["_test_errrec"], fast=True) == 1


@pytest.mark.usefixtures("scratch_registry")
def test_registry_duplicate_record_key_fails_suite_not_driver():
    @register_suite("_test_dup", description="test-only")
    def dup(fast, device):
        rec = _record(suite="_test_dup", name="same")
        return [BenchRecord.from_dict(rec), BenchRecord.from_dict(rec)]

    @register_suite("_test_after_dup", description="test-only")
    def after(fast, device):
        return [BenchRecord.from_dict(_record(suite="_test_after_dup"))]

    report = BenchReport("t3", environment=_report([])["environment"])
    failures = run_suites(report, only=["_test_dup", "_test_after_dup"], fast=True)
    # the duplicate fails its suite but the driver moves on
    assert failures == 1
    assert "duplicate" in report.errors[0]["error"]
    assert [r.suite for r in report.records][-1] == "_test_after_dup"


@pytest.mark.usefixtures("scratch_registry")
def test_registry_hands_each_suite_the_pass_device():
    seen = []

    @register_suite("_test_device", description="test-only")
    def where(fast, device):
        seen.append((fast, device))
        return [BenchRecord.from_dict(_record(suite="_test_device"))]

    report = BenchReport("t4", environment=_report([])["environment"])
    assert run_suites(report, only=["_test_device"], fast=False, device=torch.device("cpu")) == 0
    assert seen == [(False, torch.device("cpu"))]


# ---------------------------------------------------------------------------
# backend matrix
# ---------------------------------------------------------------------------
def test_matrix_expansion_filters_by_device_count():
    backends = lp_backend_specs()  # the registry, sharded fanned out 1/2/4
    params = [{"alg": "dhlp1"}, {"alg": "dhlp2"}]
    cells, skipped = expand_matrix(backends, params, device_count=2)
    names = {b.name for b, _ in cells}
    # a sharded column runs when the world has exactly its ranks
    assert names == {"dense", "kernel", "sparse", "sharded2"}
    assert [b.name for b in skipped] == ["sharded1", "sharded4"]
    assert len(cells) == 4 * 2
    # params are copied per cell, not shared
    cells[0][1]["alg"] = "mutated"
    assert params[0]["alg"] == "dhlp1"
    _, skipped1 = expand_matrix(backends, params, device_count=1)
    assert [b.name for b in skipped1] == ["sharded2", "sharded4"]
    assert BackendSpec("sharded8", "sharded", devices=8).available(4) is False
    assert BackendSpec("sharded8", "sharded", devices=8).available(8) is True
    assert [s.name for s in lp_backend_specs(full=True) if s.kind == "sharded"] == [
        "sharded1", "sharded2", "sharded4", "sharded8"]


def test_matrix_specs_iterate_registry():
    """Every registered backend is a matrix column, under the key the
    reference gives the same backend."""
    from repro.bench.matrix import lp_backend_specs as ref_specs
    from repro_torch.engine import available_backends

    fast = [s.name for s in lp_backend_specs()]
    assert set(available_backends()) == {"dense", "kernel", "sharded", "sparse"}
    assert fast == [s.name for s in ref_specs()]
    assert [s.name for s in lp_backend_specs(full=True)] == [s.name for s in ref_specs(full=True)]


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
def test_roofline_cost_model_is_the_references():
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import roofline as ref_roofline
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    for kw in (dict(nnz=5000, num_nodes=104, s=16), dict(nnz=123, num_nodes=7, s=3, storage_bytes=2)):
        assert roofline.lp_round_cost(**kw) == ref_roofline.lp_round_cost(**kw)


@pytest.mark.parametrize(
    "name,model",
    [("NVIDIA H100 80GB HBM3", "h100_sxm"), ("NVIDIA H100 SXM5 80GB", "h100_sxm"),
     ("NVIDIA H100 PCIe", "h100_pcie"), ("NVIDIA A100-SXM4-80GB", None), ("cpu", None)],
)
def test_roofline_peak_table_by_card(name, model):
    if model is None:
        with pytest.raises(ValueError, match="no peak table"):
            roofline.peak_model(name)
        return
    assert roofline.peak_model(name) == model
    cost = {"flops": roofline.PEAKS[model]["flops"], "bytes": roofline.PEAKS[model]["bytes_per_s"]}
    out = roofline.achieved_vs_peak(0.5, cost, model)
    assert out["frac_peak_flops"] == pytest.approx(2.0)
    assert out["frac_peak_bw"] == pytest.approx(2.0)


def test_roofline_on_the_cpu_uses_the_sxm_table():
    assert roofline.device_peak_model("cpu") == "h100_sxm"
    assert roofline.PEAKS["h100_sxm"] == {"flops": 67e12, "bytes_per_s": 3.35e12}


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------
def test_compare_pass_improvement_and_new_records():
    base = _report([_record(name="a", median=1.0)])
    cand = _report(
        [_record(name="a", median=0.5), _record(name="extra", median=1.0)]
    )
    res = compare_reports(base, cand, tolerance=0.30)
    assert res.ok and res.compared == 1
    assert [f.kind for f in res.improvements] == ["timing"]
    assert res.new_keys == ["suite/extra@dense"]


def test_compare_timing_regression_gates_only_on_env_match():
    base = _report([_record(name="a", median=1.0)])
    cand = _report([_record(name="a", median=1.5)])
    res = compare_reports(base, cand, tolerance=0.30)
    assert not res.ok and res.regressions[0].kind == "timing"
    # same regression on different hardware: warning, not failure
    cand_other = _report([_record(name="a", median=1.5)], env={"machine": "arm64"})
    res2 = compare_reports(base, cand_other, tolerance=0.30)
    assert res2.ok and not res2.env_match
    assert [f.kind for f in res2.warnings] == ["timing"]
    # host_class alone also breaks the fingerprint (CPU platform/machine
    # are identical across most linux x86_64 hosts)
    cand_host = _report([_record(name="a", median=1.5)], env={"host_class": "ci"})
    res_host = compare_reports(base, cand_host, tolerance=0.30)
    assert res_host.ok and not res_host.env_match
    # so does a card's power limit
    cand_power = _report([_record(name="a", median=1.5)], env={"power_limit": "x, 500.00 W"})
    assert compare_reports(base, cand_power).ok
    # on equal cards, the report-only policy keeps the finding as a warning
    res_report = compare_reports(base, cand, tolerance=0.30, gate_timing=False)
    assert res_report.ok and res_report.env_match and not res_report.timing_gated
    assert [f.kind for f in res_report.warnings] == ["timing"]
    # within tolerance passes
    res3 = compare_reports(
        base, _report([_record(name="a", median=1.2)]), tolerance=0.30
    )
    assert res3.ok


def test_compare_strict_metrics_hard_fail_even_on_env_mismatch():
    base = _report(
        [_record(name="a", derived={"outer_iters": 13.0}, strict=["outer_iters"])]
    )
    cand = _report(
        [_record(name="a", derived={"outer_iters": 40.0}, strict=["outer_iters"])],
        env={"machine": "arm64"},
    )
    res = compare_reports(base, cand)
    assert not res.ok
    assert res.regressions[0].kind == "strict"
    assert res.regressions[0].metric == "outer_iters"


def test_compare_missing_and_error_records_fail():
    base = _report([_record(name="a"), _record(name="b")])
    cand = _report([_record(name="a", error="exploded")])
    res = compare_reports(base, cand)
    kinds = sorted(f.kind for f in res.regressions)
    assert kinds == ["error", "missing"]


def test_compare_cli_paths(tmp_path, capsys):
    base_path = tmp_path / "baseline.json"
    cand_path = tmp_path / "BENCH_torch_ci.json"
    cand_path.write_text(json.dumps(_report([_record(name="a", median=1.0)])))

    # missing baseline: exit 2, or 0 with --allow-missing
    argv = ["--baseline", str(base_path), "--candidate", str(cand_path)]
    assert compare_main(argv) == 2
    assert compare_main(argv + ["--allow-missing"]) == 0

    # pass path + json summary
    base_path.write_text(json.dumps(_report([_record(name="a", median=1.0)])))
    out_json = tmp_path / "summary.json"
    assert compare_main(argv + ["--json", str(out_json)]) == 0
    assert json.loads(out_json.read_text())["ok"] is True

    # regression path: a wall-time regression is reported by default and
    # fails under --timing gate
    cand_path.write_text(json.dumps(_report([_record(name="a", median=9.0)])))
    assert compare_main(argv) == 0
    out = capsys.readouterr().out
    assert "timing reported, not gated" in out and "REGRESSIONS" not in out
    assert compare_main(argv + ["--timing", "gate"]) == 1
    assert "REGRESSIONS" in capsys.readouterr().out

    # corrupt baseline: unreadable (2), never waived by --allow-missing
    base_path.write_text("{not json")
    assert compare_main(argv) == 2
    assert compare_main(argv + ["--allow-missing"]) == 2
    # schema-invalid candidate: also unreadable
    base_path.write_text(json.dumps(_report([_record(name="a")])))
    cand_path.write_text(json.dumps({"schema_version": 999}))
    assert compare_main(argv) == 2


def _pair(base, cand):
    return (None if base is None else _report(base), None if cand is None else _report(cand))


COMPARE_PAIRS = {
    "pass": _pair([_record(name="a")], [_record(name="a")]),
    "timing": _pair([_record(name="a")], [_record(name="a", median=9.0)]),
    "strict": _pair([_record(name="a", derived={"k": 1.0}, strict=["k"])],
                    [_record(name="a", derived={"k": 2.0}, strict=["k"])]),
    "missing_record": _pair([_record(name="a"), _record(name="b")], [_record(name="a")]),
    "error_record": _pair([_record(name="a")], [_record(name="a", error="x")]),
    "new_record": _pair([_record(name="a")], [_record(name="a"), _record(name="c")]),
    "no_baseline": _pair(None, [_record(name="a")]),
    "no_candidate": _pair([_record(name="a")], None),
    "corrupt_baseline": ("{not json", _report([_record(name="a")])),
    "invalid_candidate": (_report([_record(name="a")]), {"schema_version": 999}),
}


@pytest.mark.parametrize("flags", [[], ["--allow-missing"], ["--tolerance", "20"]])
@pytest.mark.parametrize("case", sorted(COMPARE_PAIRS))
def test_compare_cli_exit_codes_match_the_reference(tmp_path, capsys, case, flags):
    base, cand = COMPARE_PAIRS[case]
    paths = []
    for name, doc in (("baseline.json", base), ("candidate.json", cand)):
        path = tmp_path / name
        if doc is not None:
            path.write_text(doc if isinstance(doc, str) else json.dumps(doc))
        paths.append(str(path))
    argv = ["--baseline", paths[0], "--candidate", paths[1]] + flags
    # --timing gate: the reference's policy, which gates wall times
    assert compare_main(argv + ["--timing", "gate"]) == rcompare.main(argv)
    # the default reports wall times and gates everything else as the reference does
    want = 0 if case == "timing" else rcompare.main(argv)
    assert compare_main(argv) == want


def test_compare_defaults_are_the_ports():
    from repro_torch.bench.compare import DEFAULT_BASELINE

    assert Path(DEFAULT_BASELINE) == ROOT / "src" / "repro_torch" / "bench" / "baseline_h100.json"
    assert Path(DEFAULT_BASELINE).is_file()
    doc = load_report(DEFAULT_BASELINE)
    assert doc["environment"]["backend"] == "cuda"
    assert doc["environment"]["host_class"] != "ephemeral-1core-container"


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------
def test_bench_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.bench, repro_torch.bench.compare, repro_torch.bench.driver\n"
        "import repro_torch.bench.matrix, repro_torch.bench.roofline\n"
        "repro_torch.bench.driver.import_suite_modules()\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax', "
        "'benchmarks')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(repro_torch.bench.all_suites()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10"]  # the ported suites, fig34_parallelism among them


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device times and the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_time_cuda_events_times_device_work(dev):
    a = torch.rand((2048, 2048), device=dev)
    one = time_cuda_events(lambda: a @ a, dev, warmup=1, iters=4, repeats=3)
    four = time_cuda_events(lambda: [a @ a for _ in range(4)], dev, warmup=1, iters=4, repeats=3)
    assert one.repeats == 3 and one.warmup == 1
    assert 0.0 < one.min_s <= one.median_s <= one.max_s
    assert four.median_s > 2.0 * one.median_s  # device time, not the enqueue
    # the wall-clock timer synchronizes the card on CUDA results
    wall = time_callable(lambda: a @ a, warmup=1, repeats=3)
    assert wall.median_s >= 0.5 * one.median_s


@pytest.mark.gpu
def test_time_cuda_events_flushes_l2_outside_the_timed_launch(dev):
    from repro_torch.bench.timing import L2_FLUSH_BYTES

    tiny = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = time_cuda_events(lambda: tiny.add_(1), dev, repeats=7)
    # the flush buffer is written before each launch and freed after
    assert torch.cuda.max_memory_allocated(dev) - before >= L2_FLUSH_BYTES
    assert torch.cuda.memory_allocated(dev) == before
    # a one-element add takes microseconds; the ~0.1 ms write of 256 MB
    # before it lies outside the events
    assert 0.0 < stats.median_s < 50e-6
    assert float(tiny) == 72  # 2 warm-up calls + 7 samples of 10


@pytest.mark.gpu
def test_kernels_suite_cuda_records(dev):
    from repro_torch.bench.suites.kernels import records

    recs = records(fast=True, device=dev)
    by = {(r.name, r.backend): r for r in recs}
    names = {r.name for r in recs}
    assert names == {"lp_round_512x256", "csr_aggregate_512x16", "embedding_bag_b4096",
                     "attention_l256"}
    for name in names:
        ref, cuda = by[(name, "torch_ref")], by[(name, "cuda")]
        assert cuda.strict == ["agree_ref"] and cuda.derived["agree_ref"] == 1.0
        assert cuda.derived["max_abs_diff_vs_ref"] <= 5e-4
        assert cuda.params == ref.params and ref.strict == []
        validate_record(cuda.to_dict())
