"""Port observability (queue A.4) vs the JAX reference.

Each test builds its inputs once (numpy, or the seeded scenario generator
both packages share bit for bit) and runs both packages on them:

* the committed quickstart spec, ``obs`` section and all, through both
  Sessions: each package's telemetry directory passes the OTHER package's
  ``validate_dir``, and the convergence digests agree (equal supersteps,
  residuals within 5e-3, the ``agree_dense`` tolerance);
* ``render_openmetrics``, ``summarize`` and ``lint_openmetrics`` give the
  same string, digest and problems for the same registry lines;
* ``SLOWatchdog`` under a fake clock gives the same breach/recovery event
  sequence and the same degradation knobs;
* ``observed_solve`` on ``dense``, ``sparse`` and ``kernel`` (fused and
  legacy), with momentum and with ``seed_chunk``: equal supersteps, the
  ``solve.residual`` series within 5e-3, equal top-10 lists;
* the profile level (``torch.profiler`` trace, the kernel hook's
  ``.ref`` variants on the CPU) and the ``obs`` subcommand, which reads
  files only and never initialises CUDA.
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.core as rc
import repro.engine as re_
import repro.obs as ro
import repro.scenarios as rs
import repro.serve as rsv
import repro_torch.api as ta
import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.obs as to
import repro_torch.scenarios as ts
import repro_torch.serve as tsv
from repro.obs.solve import observed_solve as r_observed
from repro.obs.summary import load_dir as r_load_dir
from repro.obs.summary import summarize as r_summarize
from repro_torch.launch import cli as tcli
from repro_torch.obs import profiler as tprof
from repro_torch.obs.solve import observed_solve as t_observed
from repro_torch.obs.summary import load_dir as t_load_dir
from repro_torch.obs.summary import render as t_render
from repro_torch.obs.summary import summarize as t_summarize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = os.path.join(ROOT, "examples", "specs", "quickstart_run.json")
AGREE_TOL = 5e-3
TEL_FILES = ["events.jsonl", "metrics.jsonl", "metrics.prom", "summary.json"]


class FakeClock:
    """Deterministic monotonic clock: each read advances by ``step``."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def quickstart_runs(tmp_path_factory):
    """The committed quickstart spec through both Sessions (written runs)."""
    d = json.load(open(QUICKSTART))
    t_root = str(tmp_path_factory.mktemp("port"))
    r_root = str(tmp_path_factory.mktemp("ref"))
    t_arts = ta.Session(ta.RunSpec.from_dict(d), results_root=t_root, device="cpu").run(
        echo=_quiet
    )
    r_arts = ra.Session(ra.RunSpec.from_dict(d), results_root=r_root).run(echo=_quiet)
    return (
        os.path.join(t_root, "quickstart"),
        os.path.join(r_root, "quickstart"),
        {a.kind: a for a in t_arts},
        {a.kind: a for a in r_arts},
    )


@pytest.fixture(scope="module")
def bundles():
    kw = dict(scale=0.5, seed=0, cache=False)
    return ts.generate("streaming", **kw), rs.generate("streaming", **kw)


# ------------------------------------------------------------- quickstart


def test_quickstart_writes_the_four_artifacts(quickstart_runs):
    t_dir, r_dir, t_arts, _ = quickstart_runs
    assert sorted(os.listdir(os.path.join(t_dir, "telemetry"))) == TEL_FILES
    assert sorted(os.listdir(os.path.join(r_dir, "telemetry"))) == TEL_FILES
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(r_dir))
    assert sorted(t_arts) == ["eval", "serve", "solve"]


@pytest.mark.parametrize("direction", ["port_by_reference", "reference_by_port"])
def test_quickstart_telemetry_validates_across_packages(quickstart_runs, direction):
    t_dir, r_dir, _, _ = quickstart_runs
    if direction == "port_by_reference":
        counts = ro.validate_dir(os.path.join(t_dir, "telemetry"))
        own = to.validate_dir(os.path.join(t_dir, "telemetry"))
    else:
        counts = to.validate_dir(os.path.join(r_dir, "telemetry"))
        own = ro.validate_dir(os.path.join(r_dir, "telemetry"))
    assert counts == own
    assert counts["meta"] == 2 and counts["summary"] == 1 and counts["openmetrics"] > 0
    assert counts["span"] == 4  # run + three phases


def test_quickstart_convergence_digest_matches_reference(quickstart_runs):
    t_dir, r_dir, t_arts, r_arts = quickstart_runs
    got = t_summarize(*t_load_dir(os.path.join(t_dir, "telemetry")))
    want = r_summarize(*r_load_dir(os.path.join(r_dir, "telemetry")))
    gc, wc = got["convergence"], want["convergence"]
    assert gc["supersteps"] == wc["supersteps"] == t_arts["solve"].outer_iters
    assert gc["active_columns"] == wc["active_columns"]
    np.testing.assert_allclose(gc["residuals"], wc["residuals"], rtol=0, atol=AGREE_TOL)
    assert got["counters"]["solve.supersteps"] == want["counters"]["solve.supersteps"]
    assert got["counters"]["solve.columns"] == want["counters"]["solve.columns"]
    assert [p["name"] for p in got["phases"]] == [p["name"] for p in want["phases"]]
    assert got["level"] == want["level"] == "metrics"
    assert t_arts["solve"].ranking["candidates"] == r_arts["solve"].ranking["candidates"]
    assert np.max(np.abs(t_arts["solve"].F - r_arts["solve"].F)) <= AGREE_TOL


def test_quickstart_serve_report_carries_the_watchdog(quickstart_runs):
    _, _, t_arts, r_arts = quickstart_runs
    got, want = t_arts["serve"].slo, r_arts["serve"].slo
    assert sorted(got) == sorted(want)
    for key in ("objectives", "burn_windows", "recovery_windows"):
        assert got[key] == want[key]
    assert got["windows"] >= 1
    assert t_arts["serve"].report["queries"] == r_arts["serve"].report["queries"]


def test_obs_cli_json_digest_equals_the_references(quickstart_runs, capsys):
    """One telemetry directory, both packages' ``obs --json``: one digest."""
    from repro.launch.cli import obs_main as r_obs_main

    t_dir, _, _, _ = quickstart_runs
    root = os.path.dirname(t_dir)
    assert tcli.main(["obs", "quickstart", "--results-root", root, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert r_obs_main(["quickstart", "--results-root", root, "--json"]) == 0
    assert got == json.loads(capsys.readouterr().out)


# ----------------------------------------------------- export and summary


def _registry_pair(seed):
    """The same counters, gauges and histogram observations in both
    packages' registries, drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    pair = (to.MetricsRegistry(), ro.MetricsRegistry())
    counts = rng.integers(0, 50, 4)
    gauges = rng.random((3, 5))
    lat = rng.lognormal(-5.0, 1.5, 40)
    for reg in pair:
        for i, c in enumerate(counts):
            reg.counter(f"serve.c{i}").inc(int(c))
        reg.counter("serve.cache.hits").inc(int(counts[0]))
        reg.counter("serve.cache.misses").inc(int(counts[1]) + 1)
        for i, row in enumerate(gauges):
            g = reg.gauge(f"serve.g{i}" if i else "solve.residual")
            for v in row:
                g.set(float(v))
        reg.gauge("never.set")
        h = reg.histogram("serve.latency_s")
        for v in lat:
            h.observe(float(v))
    return pair


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_openmetrics_is_the_references_string(seed):
    treg, rreg = _registry_pair(seed)
    meta = {"run_id": f"om{seed}", "schema": to.SCHEMA}
    lines = treg.to_lines()
    got = to.render_openmetrics(lines, meta=meta)
    assert got == ro.render_openmetrics(rreg.to_lines(), meta=meta)
    assert got == ro.render_openmetrics(lines, meta=meta)
    assert to.lint_openmetrics(got) == ro.lint_openmetrics(got) == []
    assert to.parse_openmetrics(got) == ro.parse_openmetrics(got)


@pytest.mark.parametrize("seed", [0, 1])
def test_summarize_gives_the_references_digest(seed):
    treg, rreg = _registry_pair(seed)
    meta = {"kind": "meta", "schema": to.SCHEMA, "run_id": "d", "level": "metrics"}
    events = [
        {"kind": "span", "id": 1, "parent": None, "span": "run", "name": "d",
         "t0": 0.0, "dur_s": 2.0},
        {"kind": "span", "id": 2, "parent": 1, "span": "phase", "name": "solve",
         "t0": 0.1, "dur_s": 1.0},
        {"kind": "event", "id": 3, "parent": 2, "name": "x", "t": 0.5, "attrs": {}},
    ]
    got = t_summarize(meta, events, treg.to_lines())
    assert got == r_summarize(meta, events, rreg.to_lines())
    from repro.obs.summary import render as r_render

    assert t_render(got) == r_render(got)


MALFORMED = {
    "no_eof": "x_total 1\n",
    "not_cumulative": '# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
    "h_count 3\n# EOF\n",
    "no_inf_bucket": '# TYPE h histogram\nh_bucket{le="1"} 1\n# EOF\n',
    "undeclared": "orphan 1\n# EOF\n",
    "counter_suffix": "# TYPE c counter\nc 1\n# EOF\n",
    "unparseable": "garbage{ 1\n",
    "inf_mismatch": '# TYPE h histogram\nh_bucket{le="1"} 1\nh_bucket{le="+Inf"} 2\n'
    "h_count 3\n# EOF\n",
    "bad_value": "# TYPE g gauge\ng abc\n# EOF\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_lint_openmetrics_rejects_what_the_reference_rejects(name):
    text = MALFORMED[name]
    got = to.lint_openmetrics(text)
    assert got == ro.lint_openmetrics(text)
    assert got  # every one of them is malformed


@pytest.mark.parametrize(
    "line",
    [
        {"kind": "meta", "schema": "wrong/v0"},
        {"kind": "span", "id": -1, "parent": None, "span": "run", "name": "r", "t0": 0,
         "dur_s": 0},
        {"kind": "span", "id": 1, "parent": None, "span": "run", "name": "r", "t0": 0,
         "dur_s": -1.0},
        {"kind": "event", "id": 1, "parent": None, "name": "", "t": 0.0},
        {"kind": "metric", "type": "gauge", "name": "g", "series": [[0.0]]},
        {"kind": "metric", "type": "histogram", "name": "h", "count": 2, "sum": 1.0,
         "edges": [1.0], "counts": [1, 0]},
        {"kind": "bogus"},
    ],
    ids=["meta", "span_id", "span_dur", "event_name", "gauge", "histogram", "kind"],
)
def test_validate_line_rejects_what_the_reference_rejects(line):
    msgs = []
    for mod in (to, ro):
        with pytest.raises(mod.TelemetryError) as err:
            mod.validate_line(line)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_load_dir_tolerates_a_torn_trailing_line_like_the_reference(tmp_path):
    tel = to.Telemetry("metrics", run_id="torn", clock=FakeClock())
    tel.event("hello")
    tel.count("serve.completed", 2)
    tel.flush(str(tmp_path))
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write('{"kind": "event", "id": 9')  # the snapshot raced the writer
    got, want = t_load_dir(str(tmp_path)), r_load_dir(str(tmp_path))
    assert got == want
    assert got[0]["truncated_lines"] == 1


# ---------------------------------------------------------------- watchdog


def small_net_arrays(seed=0, n=(18, 12, 9)):
    rng = np.random.default_rng(seed)
    P = []
    for ni in n:
        a = (rng.random((ni, ni)) < 0.35) * rng.random((ni, ni))
        np.fill_diagonal(a, 0)
        P.append((a + a.T) / 2)
    R = {(i, j): (rng.random((n[i], n[j])) < 0.3).astype(float)
         for (i, j) in [(0, 1), (0, 2), (1, 2)]}
    return P, R


def _serve_pair(**cfg_kw):
    P, R = small_net_arrays()
    base = dict(max_wait_s=1e-3, queue_depth=32)
    base.update(cfg_kw)
    t = tsv.LPServeEngine(
        tc.HeteroNetwork(P=P, R=R),
        tsv.ServeConfig(lp=tc.LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-6), **base),
        device="cpu",
    )
    r = rsv.LPServeEngine(
        rc.HeteroNetwork(P=P, R=R),
        rsv.ServeConfig(lp=rc.LPConfig(alg="dhlp2", seed_mode="fixed", sigma=1e-6), **base),
    )
    return t, r


# (objective kwargs, the script of windows: each a list of (op, name, value))
SLO_CASES = {
    "latency": (
        dict(latency_p95_ms=100.0, burn_windows=2, recovery_windows=2),
        [[("observe", "serve.latency_s", 0.01)] * 5] * 3
        + [[("observe", "serve.latency_s", 1.0)] * 5] * 4
        + [[("observe", "serve.latency_s", 0.01)] * 5] * 3,
    ),
    "error_rate": (
        dict(error_rate=0.2, burn_windows=1, recovery_windows=1),
        [[("count", "serve.completed", 10)],
         [("count", "serve.completed", 4), ("count", "serve.failed", 3),
          ("count", "serve.rejected", 3)],
         [("count", "serve.failed", 5)],
         [("count", "serve.completed", 10)]],
    ),
    "cache_hit_floor": (
        dict(cache_hit_floor=0.5, burn_windows=1, recovery_windows=1),
        [[("count", "serve.cache.hits", 9), ("count", "serve.cache.misses", 1)],
         [("count", "serve.cache.hits", 1), ("count", "serve.cache.misses", 9)],
         [],
         [("count", "serve.cache.hits", 2), ("count", "serve.cache.misses", 9)]],
    ),
    "convergence_stall": (
        dict(stall_windows=2, burn_windows=1, recovery_windows=1),
        [[("gauge", "solve.residual", r)] for r in (0.5, 0.4, 0.3, 0.3, 0.3, 0.3, 0.2)],
    ),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_watchdog_matches_the_reference_under_a_fake_clock(tmp_path, case):
    kw, script = SLO_CASES[case]
    runs = []
    for pkg, engine in zip((to, ro), _serve_pair()):
        tel = pkg.Telemetry("metrics", run_id="chaos", clock=FakeClock(step=0.001))
        tel.attach_stream(str(tmp_path / pkg.__name__), interval_s=1e9)
        dog = pkg.SLOWatchdog(tel, degradation=pkg.ServeDegradation(engine), **kw).attach()
        knobs = []
        tel.flush_tick()  # the window anchor
        for window in script:
            for op, name, value in window:
                getattr(tel, op)(name, value)
            tel.flush_tick()
            knobs.append((engine.batcher.admit_fraction("bulk"), engine.sigma_scale,
                          dog.breached, dog.degradation.level))
        events = [(e["name"], e.get("attrs")) for e in tel.events() if e["kind"] == "event"]
        runs.append((events, knobs, dog.history, dog.report()))
    assert runs[0] == runs[1]
    assert any(name == "obs.slo.breach" for name, _ in runs[0][0])


def test_degradation_knobs_match_the_reference():
    t, r = _serve_pair()
    for eng in (t, r):
        eng.batcher.set_admit_fraction("bulk", 0.25)
        eng.set_sigma_scale(4.0)
    assert t.batcher.admit_fraction("bulk") == r.batcher.admit_fraction("bulk") == 0.25
    assert t.batcher._admit_limit == r.batcher._admit_limit
    assert t.sigma_scale == r.sigma_scale == 4.0
    for eng, err in ((t, ValueError), (r, ValueError)):
        with pytest.raises(err):
            eng.set_sigma_scale(0.5)
        with pytest.raises(err):
            eng.batcher.set_admit_fraction("bulk", 0.0)
        with pytest.raises(err):
            eng.batcher.set_admit_fraction("urgent", 0.5)


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_early_exit_honors_sigma_scale_like_the_reference(bundles, scale):
    t_net, r_net = bundles[0].network, bundles[1].network
    lp = dict(alg="dhlp2", sigma=1e-4, seed_mode="fixed", backend="dense")
    t = tsv.LPServeEngine(t_net, tsv.ServeConfig(lp=tc.LPConfig(**lp), early_exit=True),
                          device="cpu")
    r = rsv.LPServeEngine(r_net, rsv.ServeConfig(lp=rc.LPConfig(**lp), early_exit=True))
    t.set_sigma_scale(scale)
    r.set_sigma_scale(scale)
    for entity in (0, 5, 40):
        got = t.query(tsv.QuerySpec(entity=entity, target_type=2, top_k=5))
        want = r.query(rsv.QuerySpec(entity=entity, target_type=2, top_k=5))
        assert got.rounds == want.rounds
        assert list(got.candidates) == list(want.candidates)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=AGREE_TOL)


# ---------------------------------------------------------- observed solve


OBSERVED = {
    "dense": ("dense", {}, {}),
    "dense_momentum": ("dense", {"momentum": 0.3}, {}),
    "dense_chunked": ("dense", {"seed_chunk": 16}, {}),
    "sparse": ("sparse", {}, {}),
    "sparse_momentum": ("sparse", {"momentum": 0.3}, {}),
    "sparse_chunked": ("sparse", {"seed_chunk": 16}, {}),
    "sparse_legacy": ("sparse", {}, {"fused_superstep": False}),
    "kernel": ("kernel", {}, {}),
    "kernel_momentum": ("kernel", {"momentum": 0.3}, {}),
    "kernel_chunked": ("kernel", {"seed_chunk": 24}, {}),
    "kernel_legacy": ("kernel", {}, {"fused_superstep": False}),
}


def _top10(F, norm):
    scores = tc.extract_outputs(F, norm).interactions[(0, 2)]
    return [list(np.argsort(-row, kind="stable")[:10]) for row in scores]


@pytest.mark.parametrize("case", sorted(OBSERVED))
def test_observed_solve_matches_the_reference(bundles, case):
    backend, cfg_kw, eng_kw = OBSERVED[case]
    cfg = dict(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False, **cfg_kw)
    t_net, r_net = bundles[0].network, bundles[1].network
    t_tel = to.Telemetry("trace", run_id="o")
    r_tel = ro.Telemetry("trace", run_id="o")
    t_eng = te.make_engine(backend, tc.LPConfig(**cfg), device="cpu", **eng_kw)
    r_eng = re_.make_engine(backend, rc.LPConfig(**cfg), **eng_kw)
    got = t_observed(t_eng, t_net, telemetry=t_tel)
    want = r_observed(r_eng, r_net, telemetry=r_tel)
    assert got.outer_iters == want.outer_iters
    assert got.converged == want.converged
    np.testing.assert_array_equal(got.per_column_iters, want.per_column_iters)
    assert np.max(np.abs(got.F - want.F)) <= AGREE_TOL
    series = [[v for _, v in tel.metrics.peek("solve.residual").series] for tel in (t_tel, r_tel)]
    assert len(series[0]) == len(series[1]) == got.outer_iters
    np.testing.assert_allclose(series[0], series[1], rtol=0, atol=AGREE_TOL)
    actives = [[v for _, v in tel.metrics.peek("solve.active_columns").series]
               for tel in (t_tel, r_tel)]
    assert actives[0] == actives[1]
    spans = [[e["name"] for e in tel.events() if e.get("span") == "superstep"]
             for tel in (t_tel, r_tel)]
    assert spans[0] == spans[1]
    assert _top10(got.F, t_net.normalize()) == _top10(want.F, r_net.normalize())
    # the observed loop lands where the port's own engine.run does
    plain = te.make_engine(backend, tc.LPConfig(**cfg), device="cpu", **eng_kw).run(t_net)
    assert plain.outer_iters == got.outer_iters
    assert np.max(np.abs(plain.F - got.F)) <= AGREE_TOL


# ----------------------------------------------------------- profile level


def test_kernel_hook_names_the_cpu_route_and_costs_nothing_uninstalled(bundles):
    net = bundles[0].network
    eng = te.make_engine("kernel", tc.LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"),
                         device="cpu")
    tel = to.Telemetry("profile", run_id="hook")
    res = eng.run(net)  # no collector: nothing recorded
    assert tel.metrics.to_lines() == []
    tprof.install_kernel_hook(tel)
    try:
        observed = t_observed(eng, net, telemetry=tel)
    finally:
        tprof.uninstall_kernel_hook()
    names = {line["name"] for line in tel.metrics.to_lines()}
    assert "kernel.csr_round_residual.ref.calls" in names
    assert "kernel.csr_round_residual.ref.latency_s" in names
    assert not any(n.endswith(".kernel.calls") for n in names)  # no card here
    buckets = len(eng._fused_plan(eng.prepare(net))[0])
    calls = tel.metrics.peek("kernel.csr_round_residual.ref.calls").value
    assert calls == buckets * observed.outer_iters
    assert observed.outer_iters == res.outer_iters
    assert tprof.kernel_clock(torch.device("cpu")) is None  # uninstalled again


def test_profile_level_session_writes_a_trace_and_valid_telemetry(tmp_path):
    d = json.load(open(QUICKSTART))
    d["obs"] = {"level": "profile"}
    d["solve"]["backend"] = "kernel"
    spec = ta.RunSpec.from_dict({k: d[k] for k in ("run_id", "network", "solve", "obs")})
    arts = ta.Session(spec, results_root=str(tmp_path), device="cpu").run(echo=_quiet)
    tel_dir = tmp_path / "quickstart" / "telemetry"
    trace = json.load(open(tel_dir / "profile" / "solve" / "trace.json"))
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "phase:solve" in names
    counts = ro.validate_dir(str(tel_dir))
    assert counts == to.validate_dir(str(tel_dir))
    digest = t_summarize(*t_load_dir(str(tel_dir)))
    assert digest["convergence"]["supersteps"] == arts[0].outer_iters
    assert digest["counters"]["kernel.csr_round_residual.ref.calls"] > 0
    events = [json.loads(line) for line in open(tel_dir / "events.jsonl")]
    assert any(e.get("name") == "profile.trace" for e in events)
    assert sum(e.get("span") == "superstep" for e in events) == arts[0].outer_iters


# --------------------------------------------------------------------- CLI


def test_obs_subcommand_never_initialises_cuda(tmp_path, monkeypatch, capsys):
    tel = to.Telemetry("metrics", run_id="r1", clock=FakeClock())
    tel.event("hello")
    tel.count("serve.completed", 1)
    tel.flush(str(tmp_path / "r1" / "telemetry"))

    def boom(*_a, **_k):
        raise AssertionError("the obs subcommand touched CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert tcli.main(["obs", "--results-root", str(tmp_path), "--validate"]) == 0
    out = capsys.readouterr().out
    assert "defaulting to most recent run: r1" in out and "schema ok" in out
    assert not torch.cuda.is_initialized()


def test_obs_subcommand_errors_like_the_reference(tmp_path, capsys):
    from repro.launch.cli import obs_main as r_obs_main

    assert tcli.main(["obs", "--results-root", str(tmp_path)]) == 2
    assert "no run with telemetry" in capsys.readouterr().err
    assert r_obs_main(["--results-root", str(tmp_path)]) == 2
    tel = to.Telemetry("metrics", run_id="r1", clock=FakeClock())
    tel.flush(str(tmp_path / "r1" / "telemetry"))
    (tmp_path / "r1" / "telemetry" / "metrics.prom").write_text("garbage{ 1\n")
    assert tcli.main(["obs", "r1", "--results-root", str(tmp_path), "--validate"]) == 1
    assert "INVALID" in capsys.readouterr().err
    assert r_obs_main(["r1", "--results-root", str(tmp_path), "--validate"]) == 1


def test_obs_follow_stops_at_max_ticks(tmp_path, capsys):
    tel = to.Telemetry("metrics", run_id="live", clock=FakeClock())
    d = str(tmp_path / "live" / "telemetry")
    tel.attach_stream(d, interval_s=0.5)
    tel.event("mid")
    tel.flush_tick()  # a run being tailed: segments and snapshots only
    assert tcli.main(["obs", "live", "--results-root", str(tmp_path), "--follow",
                      "--interval", "0.01", "--max-ticks", "1"]) == 0
    assert "run live" in capsys.readouterr().out


def test_every_port_module_and_chip_smoke_import_without_jax():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
    ``repro`` (both blocked in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert 'repro_torch.obs.profiler' in names and 'repro_torch.ft.solve' in names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 60
