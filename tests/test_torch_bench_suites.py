"""The port's bench suites at their fast sizes on the CPU, held to the
reference's committed ``benchmarks/baseline.json``.

One pass of every registered suite (module fixture, run in a fresh
working directory so the autotune cache it writes lands there) feeds one
test per suite: its record keys equal the baseline's keys for that suite
minus the ones the port does not emit (``NOT_EMITTED``: the ``lp_matrix``
columns that need a world of 2 or 4 ranks, and XLA's ``xla_ref`` kernel
records, whose counterparts here are the ``torch_ref`` ones), and its
strict metrics (iteration counts, accuracy, agreement, the roofline
FLOP/byte counts) pass ``compare_reports`` against the baseline
restricted to those keys.  ``table7_sigma``, ``table34_deleted``,
``lp_on_graph`` and ``roofline`` are also held to the reference suites
run live.  The CLI runs ``examples/specs/bench_ci.json``, all 12 suites;
a suite listed as not ported is named and refused (``--only`` exits 2).
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import BenchReport
from repro_torch.bench.compare import compare_reports
from repro_torch.bench.driver import NOT_PORTED_SUITES, import_suite_modules, run_bench
from repro_torch.bench.registry import all_suites, run_suites
from repro_torch.bench.report import environment_info, load_report
from repro_torch.bench.schema import record_key, validate_report

ROOT = Path(__file__).resolve().parent.parent
BASELINE = load_report(str(ROOT / "benchmarks" / "baseline.json"))
NOT_EMITTED = {
    "lp_matrix/dhlp2_sharded2@sharded2",
    "lp_matrix/dhlp2_sharded4@sharded4",
    "kernels/lp_round_ref_512x256@xla_ref",
    "kernels/csr_aggregate_ref_512x16@xla_ref",
    "kernels/embedding_bag_ref_b4096@xla_ref",
    "kernels/attention_ref_l256@xla_ref",
}
SUITES = ["fig34_parallelism", "kernel_variants", "kernels", "lp_matrix", "lp_on_graph",
          "roofline", "scenario_matrix", "serve", "table2_cv", "table34_deleted",
          "table56_scaling", "table7_sigma"]


@pytest.fixture(scope="module")
def cpu_pass(tmp_path_factory):
    """Every registered suite's fast pass on the CPU, as one report."""
    from repro_torch.engine import autotune
    from repro_torch.parallel.mesh import destroy_owned_world

    import_suite_modules()
    report = BenchReport("ci", environment=environment_info("cpu"))
    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(tmp_path_factory.mktemp("bench_cwd"))
    # one intra-op thread: beside the other test workers, more threads
    # oversubscribe the cores and the small solves slow down ~4x
    torch.set_num_threads(1)
    try:
        failures = run_suites(report, fast=True, device=torch.device("cpu"))
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        autotune.clear_memo()
        destroy_owned_world()  # the sharded1 column's world of one rank
    assert failures == 0, report.errors
    doc = report.to_dict()
    validate_report(doc)
    return doc


def test_registered_suites_are_the_ported_ones():
    import_suite_modules()
    names = {s.name for s in all_suites() if not s.name.startswith("_test")}
    assert names == set(SUITES)
    ref_suites = {r["suite"] for r in BASELINE["records"]}
    assert ref_suites == names | set(NOT_PORTED_SUITES)
    assert NOT_PORTED_SUITES == {}


@pytest.mark.parametrize("suite", SUITES)
def test_suite_keys_and_strict_metrics_match_the_baseline(cpu_pass, suite):
    got = [r for r in cpu_pass["records"] if r["suite"] == suite]
    keys = {record_key(r) for r in got}
    want = {record_key(r) for r in BASELINE["records"] if r["suite"] == suite}
    if suite == "kernels":
        # the oracle records under the port's backend key, the case names
        # without the reference's "_ref"
        assert keys == {k.replace("_ref_", "_").replace("@xla_ref", "@torch_ref") for k in want}
        return
    assert keys == want - NOT_EMITTED
    base = dict(BASELINE, records=[r for r in BASELINE["records"] if record_key(r) in keys])
    res = compare_reports(base, dict(cpu_pass, records=got))
    assert res.ok, [(f.key, f.metric, f.baseline, f.candidate) for f in res.regressions]
    assert res.compared == len(keys) and not res.new_keys
    for r in got:  # the strict lists are the reference's
        assert r["strict"] == next(b["strict"] for b in base["records"]
                                   if record_key(b) == record_key(r))


@pytest.mark.parametrize("suite", ["table7_sigma", "table34_deleted", "lp_on_graph", "roofline"])
def test_suite_matches_the_reference_run_live(cpu_pass, suite):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    ref = importlib.import_module(f"benchmarks.{suite}")
    want = [r.to_dict() for r in ref.records(fast=True)]
    got = [r for r in cpu_pass["records"] if r["suite"] == suite]
    assert sorted(record_key(r) for r in got) == sorted(record_key(r) for r in want)
    res = compare_reports(dict(BASELINE, records=want), dict(cpu_pass, records=got))
    assert res.ok and res.compared == len(want), res.regressions
    for r in got:
        w = next(x for x in want if record_key(x) == record_key(r))
        assert {k: r["derived"][k] for k in r["strict"]} == {k: w["derived"][k] for k in w["strict"]}


def test_kernel_variants_carry_the_h100_roofline(cpu_pass):
    recs = [r for r in cpu_pass["records"] if r["suite"] == "kernel_variants"]
    assert [r["name"] for r in recs] == ["drugnet_legacy", "drugnet_fused", "drugnet_autotuned",
                                         "drugnet_bf16", "autotune_cache",
                                         "powerlaw_race_legacy", "powerlaw_race_fused"]
    tuned = recs.pop(4)
    assert tuned["derived"]["cache_hit_second"] == 1.0 and tuned["strict"] == ["cache_hit_second"]
    for r in recs:
        assert r["params"]["peak_model"] == "h100_sxm"
        d = r["derived"]
        t = r["stats"]["median_s"] / d["supersteps"]
        assert d["frac_peak_bw"] == pytest.approx(d["round_bytes"] / t / 3.35e12)
        assert d["frac_peak_flops"] == pytest.approx(d["round_flops"] / t / 67e12)
    assert "speedup_vs_legacy" in recs[-1]["derived"]


@pytest.mark.parametrize("suite", ["roofline"])
def test_naming_a_suite_not_ported_raises(suite, monkeypatch):
    """The refusal stays for a suite listed as not ported (none is now:
    the listing is patched here), before anything runs."""
    import repro_torch.bench.driver as driver

    monkeypatch.setitem(driver.NOT_PORTED_SUITES, suite, "A.9.5")
    with pytest.raises(NotImplementedError, match="queue A\\.9\\.5\\)"):
        run_bench(only=["table7_sigma", suite], write=False, device="cpu")


def test_roofline_terms_are_the_cards(cpu_pass):
    """The roofline records' times are the strict counts over the H100
    SXM peaks (the CPU's table), the compute peak f32's for these f32
    cells, the collective one NVLink's one-way rate."""
    from repro_torch.bench.roofline import PEAKS

    peaks = PEAKS["h100_sxm"]
    recs = [r for r in cpu_pass["records"] if r["suite"] == "roofline"]
    assert len(recs) == 3
    for r in recs:
        d = r["derived"]
        assert r["params"]["peak_model"] == "h100_sxm" and r["params"]["artifact"] == "sample"
        assert d["t_compute_s"] == pytest.approx(d["flops_per_device"] / peaks["flops"])
        assert d["t_memory_s"] == pytest.approx(d["hbm_bytes_per_device"] / peaks["bytes_per_s"])
        assert d["t_collective_s"] == pytest.approx(
            d["collective_bytes_per_device"] / peaks["link_bytes_per_s"])
        assert d["roofline_bound_s"] == max(d["t_compute_s"], d["t_memory_s"],
                                            d["t_collective_s"])


def test_run_bench_writes_the_ports_report(tmp_path, monkeypatch, capsys):
    (tmp_path / ".git").mkdir()  # a repository above the working directory
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)  # the report lands here, never above
    out = run_bench(only=["table7_sigma"], label="t", device="cpu")
    assert (out.label, out.suites, out.records, out.failures) == ("t", ["table7_sigma"], 12, 0)
    assert [Path(p) for p in out.paths][0] == cwd / "BENCH_torch_t.json"
    assert sorted(p.name for p in tmp_path.iterdir()) == [".git", "cwd"]
    doc = load_report(out.paths[0])
    assert doc["environment"]["backend"] == "cpu" and len(doc["records"]) == 12
    assert "skipped" not in capsys.readouterr().out  # only a pass over every suite says so


def test_cli_runs_bench_ci_on_the_cpu(tmp_path):
    """``python -m repro_torch run examples/specs/bench_ci.json --device
    cpu --no-write`` exits 0 and runs all 12 suites, skipping none;
    ``bench --only roofline`` exits 0 with the sample's three records."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_TORCH_SCENARIO_CACHE_DIR=str(tmp_path / "cache"))
    spec = str(ROOT / "examples" / "specs" / "bench_ci.json")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", spec, "--device", "cpu", "--no-write"],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(cwd))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert not [ln for ln in lines if ln.startswith("skipped ")]
    assert "[bench] label=ci suites=12 records=63 failures=0" in lines
    # --no-write: no report and no run results; the autotune cache the
    # kernel_variants suite's sweep persists (as the reference's does) is all
    left = sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*") if p.is_file())
    assert len(left) == 1 and left[0].startswith("results/autotune/"), left
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch", "bench", "--only", "roofline",
         "--device", "cpu", "--no-write"], capture_output=True, text=True, env=env,
        timeout=120, cwd=str(cwd))
    assert roof.returncode == 0, roof.stderr[-3000:]
    assert "suites=1 records=3 failures=0" in roof.stderr
    assert sum(ln.startswith("roofline/dhlp-bio/") for ln in roof.stdout.splitlines()) == 3
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch", "bench", "--list", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=str(cwd))
    assert listed.returncode == 0
    assert [ln.split(":")[0] for ln in listed.stdout.splitlines()] == SUITES
