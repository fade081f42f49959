"""Port API and CLI vs the JAX reference: RunSpec, Session, ``python -m
repro_torch``.

The schema is shared: every committed spec and every RunSpec block of the
docs parses to the same ``to_dict()`` and content hash in both packages.
The quickstart spec without its ``obs`` section (the port's entry-point
gate) runs through ``Session.run`` in both packages — equal solve ranking
and ``outer_iters``, recovery metrics within 5e-3 — and through ``python
-m repro_torch run --device cpu`` as a subprocess.  The ``obs`` and
``ft`` sections, ``run --resume`` and the ``obs`` subcommand run and agree
with ``repro``; every section whose modules are not ported raises
``NotImplementedError`` naming its item of ``ROADMAP.md``'s queue A;
nothing falls back to the CPU unasked.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ra
import repro_torch.api as ta
from repro_torch.launch import cli as tcli

ROOT = Path(__file__).resolve().parent.parent
AGREE_TOL = 5e-3
SPEC_FILES = sorted((ROOT / "examples" / "specs").glob("*.json"))
QUICKSTART = ROOT / "examples" / "specs" / "quickstart_run.json"


def _doc_blocks():
    """Every ```json block the docs-consistency gate reads."""
    path = ROOT / "tools" / "check_doc_specs.py"
    spec = importlib.util.spec_from_file_location("check_doc_specs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = []
    for doc in mod.DEFAULT_DOCS:
        text = (ROOT / doc).read_text()
        for line, block in mod.iter_json_blocks(text):
            out.append(pytest.param(json.loads(block), id=f"{doc}:{line}"))
    return out


def _quickstart_without_obs(**overrides):
    d = json.loads(QUICKSTART.read_text())
    d.pop("obs")
    d.update(overrides)
    return d


def _same_spec(d):
    got, want = ta.RunSpec.from_dict(d), ra.RunSpec.from_dict(d)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    assert got.content_hash() == want.content_hash()
    assert got.resolved_run_id() == want.resolved_run_id()
    assert got.sections() == want.sections()
    assert ta.RunSpec.from_json(got.to_json()) == got


# ------------------------------------------------------------------- schema


@pytest.mark.parametrize("path", SPEC_FILES, ids=[p.name for p in SPEC_FILES])
def test_example_specs_match_reference(path):
    _same_spec(json.loads(path.read_text()))
    assert ta.RunSpec.from_file(str(path)).to_dict() == ra.RunSpec.from_file(str(path)).to_dict()


@pytest.mark.parametrize("d", _doc_blocks())
def test_doc_spec_blocks_match_reference(d):
    _same_spec(d)


BAD_SPECS = [
    {"network": {"kind": "graph"}},
    {"network": {"kind": "drugnet"}, "solve": {"alg": "dhlp3"}},
    {"network": {"kind": "drugnet"}, "solve": {"alpha": 1.5}},
    {"network": {"kind": "drugnet"}, "solve": {"devices": 2, "backend": "dense"}},
    {"network": {"kind": "drugnet"}, "solve": {"sigma": 1e-3, "bogus": 1}},
    {"network": {"kind": "drugnet"}, "eval": {"protocol": "holdout"}},
    {"network": {"kind": "drugnet"}, "serve": {"engine": "sparse"}, "solve": {"backend": "dense"}},
    {"network": {"kind": "drugnet"}, "serve": {"priority": "urgent"}},
    {"network": {"kind": "drugnet"}, "obs": {"level": "off", "slo": {"latency_p95_ms": 5.0}}},
    {"network": {"kind": "drugnet"}, "run_id": "../escape"},
    {"network": {"kind": "drugnet"}, "train": {"steps": 3}},
    {"unknown_section": {}},
]


@pytest.mark.parametrize("d", BAD_SPECS)
def test_validation_messages_match_reference(d):
    msgs = []
    for api in (ta, ra):
        with pytest.raises(api.SpecError) as err:
            api.RunSpec.from_dict(d)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_lp_config_is_the_ports():
    from repro_torch.core.solver import LPConfig

    solve = ta.SolveSpec(alg="dhlp2", sigma=1e-4, backend="kernel", momentum=0.0)
    cfg = solve.to_lp_config(seed_mode="fixed")
    assert isinstance(cfg, LPConfig)
    want = ra.SolveSpec(alg="dhlp2", sigma=1e-4, backend="kernel").to_lp_config(
        seed_mode="fixed"
    )
    for f in ("alg", "alpha", "sigma", "mode", "seed_mode", "max_iter", "backend",
              "storage_dtype", "autotune", "momentum"):
        assert getattr(cfg, f) == getattr(want, f), f


# ------------------------------------------------------------------ session


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref")
    spec = ra.RunSpec.from_dict(_quickstart_without_obs())
    arts = ra.Session(spec, results_root=str(root)).run(echo=lambda _: None)
    return {a.kind: a for a in arts}, sorted(os.listdir(root / spec.resolved_run_id()))


def test_quickstart_session_matches_reference(reference_run):
    spec = ta.RunSpec.from_dict(_quickstart_without_obs())
    arts = {a.kind: a for a in ta.Session(spec, device="cpu").run(write=False)}
    want, _ = reference_run
    assert sorted(arts) == sorted(want) == ["eval", "serve", "solve"]
    got_s, want_s = arts["solve"], want["solve"]
    assert got_s.ranking["candidates"] == want_s.ranking["candidates"]
    np.testing.assert_allclose(
        got_s.ranking["scores"], want_s.ranking["scores"], rtol=0, atol=AGREE_TOL
    )
    assert (got_s.outer_iters, got_s.converged, got_s.backend) == (
        want_s.outer_iters,
        want_s.converged,
        want_s.backend,
    )
    assert np.max(np.abs(got_s.F - want_s.F)) <= AGREE_TOL
    got_e, want_e = arts["eval"], want["eval"]
    assert sorted(got_e.metrics) == sorted(want_e.metrics)
    for k, v in want_e.metrics.items():
        assert abs(got_e.metrics[k] - v) <= AGREE_TOL, k
    got_r, want_r = arts["serve"].report, want["serve"].report
    assert got_r["queries"] == want_r["queries"] > 0
    assert got_r["deltas_applied"] == want_r["deltas_applied"] == 8


def test_session_shares_one_prepared_engine():
    spec = ta.RunSpec.from_dict(_quickstart_without_obs())
    session = ta.Session(spec, device="cpu")
    session.solve()
    prepared = session.engine._op_cache
    served = session.serve_engine()
    assert served._engine is session.engine and served.state.norm is session.norm
    assert session.engine.device.type == session.eval_engine.device.type == "cpu"
    from repro_torch.serve import QuerySpec

    served.query(QuerySpec(entity=0, target_type=2, top_k=3))
    assert session.engine._op_cache is prepared


def test_session_refuses_the_cpu_unasked(monkeypatch):
    spec = ta.RunSpec.from_dict(_quickstart_without_obs())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.Session(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.Session(spec, device="cuda")


def test_cli_run_subprocess_writes_the_references_artifacts(tmp_path, reference_run):
    spec_path = tmp_path / "quickstart_no_obs.json"
    spec_path.write_text(json.dumps(_quickstart_without_obs()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", str(spec_path), "--device", "cpu",
         "--results-root", str(tmp_path / "results")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "[solve] dhlp2 on dense: converged=True" in out.stdout
    run_dir = tmp_path / "results" / "quickstart"
    _, want_files = reference_run
    assert sorted(os.listdir(run_dir)) == want_files
    solve = json.loads((run_dir / "solve.json").read_text())
    assert solve["ranking"]["candidates"] == reference_run[0]["solve"].ranking["candidates"]


# ---------------------------------------- ported sections, and the rest named


def _quiet(*_a, **_k):
    pass


# each case: its spec overrides, and the queue item it names (None: ported,
# so it runs and is held to the reference)
NOT_PORTED_SPECS = [
    ("obs_metrics", {"obs": {"level": "metrics"}}, None),
    ("obs_slo", {"obs": json.loads(QUICKSTART.read_text())["obs"]}, None),
    ("ft", {"ft": {"interval": 2}}, None),
    ("bench", {"bench": {"suites": ["table7_sigma"]}}, None),
    ("train", {"train": {"arch": "gcn-cora", "steps": 2}}, None),
    ("dryrun", {"dryrun": {"archs": ["dhlp-bio"], "shapes": ["scale_1m"]}}, None),
    ("sharded", {"solve": {"backend": "sharded", "devices": 1, "seed_mode": "fixed"}}, None),
]


@pytest.mark.parametrize(
    "overrides,item", [p[1:] for p in NOT_PORTED_SPECS], ids=[p[0] for p in NOT_PORTED_SPECS]
)
def test_unported_sections_raise_and_name_their_item(tmp_path, request, overrides, item):
    """A section still to port raises, names its queue item and writes
    nothing; a ported one (``obs``, ``ft``, ``sharded`` on a world of one
    gloo rank) runs like ``repro``'s."""
    from repro_torch.parallel.mesh import destroy_owned_world

    request.addfinalizer(destroy_owned_world)  # the sharded case's world
    d = _quickstart_without_obs()
    d.update(overrides)
    spec = ta.RunSpec.from_dict(d)
    session = ta.Session(spec, results_root=str(tmp_path), device="cpu")
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(d))
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"queue {item}"):
            session.run()
        assert not (tmp_path / spec.resolved_run_id()).exists()  # nothing written
        # and through the CLI: exit 2, the message on stderr
        assert tcli.main(["run", str(path), "--device", "cpu", "--no-write"]) == 2
        return
    if "train" in overrides:  # ported (A.9.4): the train stage beside the others
        got = {a.kind: a for a in session.run(echo=_quiet)}
        want = {a.kind: a for a in ra.Session(ra.RunSpec.from_dict(d),
                                              results_root=str(tmp_path / "ref")).run(echo=_quiet)}
        assert sorted(got) == sorted(want) == ["eval", "serve", "solve", "train"]
        assert got["solve"].ranking["candidates"] == want["solve"].ranking["candidates"]
        t, r = got["train"], want["train"]
        assert (t.arch, t.family, t.steps, t.retries, t.resumed) == (
            r.arch, r.family, r.steps, r.retries, r.resumed)
        assert np.isfinite([t.first_loss, t.last_loss]).all()
        assert (tmp_path / spec.resolved_run_id() / "train.json").exists()
        assert tcli.main(["run", str(path), "--only", "train", "--device", "cpu",
                          "--no-write"]) == 0
        return
    if "dryrun" in overrides:  # ported (A.9.5): the census beside the other stages
        got = {a.kind: a for a in session.run(echo=_quiet)}
        assert sorted(got) == ["dryrun", "eval", "serve", "solve"]
        (rec,) = got["dryrun"].cells
        sample = json.loads((ROOT / "benchmarks" / "data" / "dryrun_sample.jsonl")
                            .read_text().splitlines()[0])
        assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (
            sample["arch"], sample["shape"], sample["mesh"], "ok")
        assert rec["memory"]["argument_size_in_bytes"] == sample["memory"][
            "argument_size_in_bytes"]
        run_dir = tmp_path / spec.resolved_run_id()
        assert (run_dir / "dryrun.json").exists()
        assert (run_dir / "telemetry" / "dryrun.jsonl").exists()
        assert tcli.main(["run", str(path), "--only", "dryrun", "--device", "cpu",
                          "--no-write"]) == 0
        return
    if "bench" in overrides:  # ported (A.6): one cheap suite, written nowhere
        got = session.bench(write=False)
        want = ra.Session(ra.RunSpec.from_dict(d)).bench(write=False)
        assert (got.label, got.suites, got.records, got.failures) == ("ci", ["table7_sigma"], 12, 0)
        assert (got.suites, got.records, got.failures) == (want.suites, want.records, want.failures)
        assert tcli.main(["run", str(path), "--only", "bench", "--device", "cpu",
                          "--no-write"]) == 0
        return
    got = {a.kind: a for a in session.run(echo=_quiet)}
    want = {a.kind: a for a in ra.Session(ra.RunSpec.from_dict(d),
                                          results_root=str(tmp_path / "ref")).run(echo=_quiet)}
    assert sorted(got) == sorted(want) == ["eval", "serve", "solve"]
    assert got["solve"].ranking["candidates"] == want["solve"].ranking["candidates"]
    assert got["solve"].outer_iters == want["solve"].outer_iters
    assert sorted(got["solve"].ft) == sorted(want["solve"].ft)
    assert sorted(got["serve"].ft) == sorted(want["serve"].ft)
    assert sorted(got["serve"].slo) == sorted(want["serve"].slo)
    assert got["serve"].report["queries"] == want["serve"].report["queries"]
    run_dir = tmp_path / spec.resolved_run_id()
    ref_dir = tmp_path / "ref" / spec.resolved_run_id()
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(ref_dir))
    if "obs" in overrides:
        import repro.obs as ro

        ro.validate_dir(str(run_dir / "telemetry"))  # the reference's schema gate
    # checkpoints are written with --no-write too: keep them under tmp_path
    assert tcli.main(["run", str(path), "--device", "cpu", "--no-write",
                      "--results-root", str(tmp_path / "cli")]) == 0


def test_unported_stage_methods_name_their_item(tmp_path):
    """``bench`` runs on the session's device (here the CPU); ``train``
    asks for its section; ``dryrun`` sweeps the cells its section names,
    and the ``roofline`` suite runs, as ``repro``'s stages do; nothing is
    written without ``write``."""
    spec = ta.RunSpec.from_dict(_quickstart_without_obs(
        bench={"suites": ["table7_sigma"]},
        dryrun={"archs": ["dhlp-bio"], "shapes": ["scale_1m"], "mesh": "multi"}))
    session = ta.Session(spec, results_root=str(tmp_path), device="cpu")
    art = session.bench(write=False)
    assert (art.suites, art.records, art.failures, art.report_paths) == (["table7_sigma"], 12, 0, [])
    with pytest.raises(ta.SpecError, match="needs a train section"):
        session.train()
    dry = session.dryrun()
    assert (dry.mesh, [c["status"] for c in dry.cells]) == ("multi", ["ok"])
    assert dry.summary()["statuses"] == {"ok": 1} and len(dry.offsets) == 1
    spec = ta.RunSpec.from_dict(_quickstart_without_obs(bench={"suites": ["roofline"]}))
    (art,) = ta.Session(spec, results_root=str(tmp_path), device="cpu").run(["bench"],
                                                                              write=False)
    want = ra.Session(ra.RunSpec.from_dict(_quickstart_without_obs(
        bench={"suites": ["roofline"]}))).bench(write=False)
    assert (art.suites, art.records, art.failures) == (want.suites, want.records,
                                                       want.failures) == (["roofline"], 3, 0)
    assert not list(tmp_path.iterdir())  # write=False: nothing written


@pytest.mark.parametrize("stage", ["solve", "serve_engine", "serve"])
def test_ft_section_raises_on_each_stage_called_alone(tmp_path, stage):
    """Each stage called alone runs with the ``ft`` section as
    ``repro``'s does: the checkpointed solve, the FT envelope on the serve
    engine, guarded serving."""
    d = _quickstart_without_obs()
    d["ft"] = {"interval": 2}
    got = getattr(ta.Session(ta.RunSpec.from_dict(d), results_root=str(tmp_path / "t"),
                             device="cpu"), stage)()
    want = getattr(ra.Session(ra.RunSpec.from_dict(d), results_root=str(tmp_path / "r")),
                   stage)()
    if stage == "serve_engine":
        assert sorted(got.ft_stats()) == sorted(want.ft_stats())
        assert got.ft_stats()["checkpoints"] == want.ft_stats()["checkpoints"] == 1
        got.close_ft()
        want.close_ft()
        return
    assert sorted(got.ft) == sorted(want.ft)
    if stage == "solve":
        assert got.ranking["candidates"] == want.ranking["candidates"]
        assert got.ft["checkpoints"] == want.ft["checkpoints"] > 0
        assert got.ft["resumed_from"] is want.ft["resumed_from"] is None
    else:  # a snapshot every 2 batches: the batching is the replay clock's
        assert got.report["queries"] == want.report["queries"]
        assert got.ft["checkpoints"] > 0 and want.ft["checkpoints"] > 0


def _resume_spec():
    """A solve-only spec with an ft section, stored where ``--resume``
    looks for it after its first run died at superstep 3."""
    d = _quickstart_without_obs()
    for section in ("eval", "serve"):
        d.pop(section)
    d["ft"] = {"interval": 2, "inject_solve_fault": [3]}
    return d


@pytest.mark.parametrize(
    "argv,item",
    [
        ([str(QUICKSTART), "--device", "cpu"], None),
        (["--resume", "quickstart", "--device", "cpu"], None),
        (["--network", "drugnet", "--bench", "table7_sigma", "--device", "cpu", "--no-write"],
         None),
        (["--network", "drugnet", "--obs", "--device", "cpu", "--no-write"], None),
    ],
    ids=["full_quickstart", "resume", "run_bench", "run_obs"],
)
def test_cli_run_names_the_queue_item(tmp_path, capsys, argv, item):
    """``run`` exits 2 naming the queue item of what is still to port;
    the full quickstart, ``--resume``, ``--bench`` and ``--obs`` now run
    and print what ``repro``'s CLI prints for the solve (the bench pass)."""
    from repro.launch.cli import run_main as r_run_main

    if item is not None:
        assert tcli.main(["run"] + argv) == 2
        assert f"ROADMAP.md queue {item}" in capsys.readouterr().err
        return
    roots = [str(tmp_path / "t"), str(tmp_path / "r")]
    if argv[0] == "--resume":
        import repro.ft as rft
        import repro_torch.ft as tft

        (tmp_path / "spec.json").write_text(json.dumps(_resume_spec()))
        with pytest.raises(tft.TransientWorkerError):
            tcli.main(["run", str(tmp_path / "spec.json"), "--device", "cpu",
                       "--results-root", roots[0]])
        with pytest.raises(rft.TransientWorkerError):
            r_run_main([str(tmp_path / "spec.json"), "--results-root", roots[1]])
        capsys.readouterr()
    rc = tcli.main(["run"] + argv + ["--results-root", roots[0]])
    got = capsys.readouterr().out
    assert rc == 0
    ref_argv = [a for a in argv if a not in ("--device", "cpu")]
    assert r_run_main(ref_argv + ["--results-root", roots[1]]) == 0
    want = capsys.readouterr().out

    def lines(out):  # the solve's ranking and checkpoints, the eval's metrics, the bench
        keep = ("[solve] top-", "[solve] ft: ", "[eval] recovery", "[bench] label=")
        return [ln.rsplit(" (", 1)[0] for ln in out.splitlines() if ln.startswith(keep)]

    assert lines(got) == lines(want)
    assert any(ln.startswith(("[solve] top-", "[bench] label=ci suites=1 records=12"))
               for ln in lines(got))
    if argv[0] == "--resume":
        assert "resumed_from=2" in got and "resumed_from=2" in want


# ids kept from when ``bench`` still named its queue item, A.6
@pytest.mark.parametrize("cmd", ["obs", "bench"], ids=["obs-None", "bench-A.6"])
def test_cli_unported_subcommands(tmp_path, capsys, cmd):
    """``bench`` runs a suite on the CPU and prints the records ``repro``'s
    ``bench`` prints (the metrics, not the times); ``obs`` renders a run's
    telemetry as ``repro``'s does."""
    if cmd == "bench":
        from repro.launch.cli import bench_main as r_bench_main

        argv = ["--only", "table7_sigma", "--no-write"]
        with pytest.warns(DeprecationWarning, match="repro_torch run"):
            assert tcli.main([cmd, *argv, "--device", "cpu"]) == 0
        got = capsys.readouterr()
        with pytest.warns(DeprecationWarning):
            assert r_bench_main(argv) == 0
        want = capsys.readouterr()

        def records(out):  # name and derived metrics of each record line
            return [(f[0], f[2]) for f in (ln.split(",") for ln in out.splitlines())
                    if f[0].startswith("table7_sigma/")]

        assert records(got.out) == records(want.out) and len(records(got.out)) == 12
        assert got.err.splitlines()[-1] == "suites=1 records=12 failures=0"
        return
    import repro.obs as ro
    from repro.launch.cli import obs_main as r_obs_main

    tel = ro.Telemetry("metrics", run_id="r1")
    tel.count("serve.completed", 3)
    tel.observe("serve.latency_s", 0.01)
    tel.flush(str(tmp_path / "r1" / "telemetry"))
    assert tcli.main([cmd, "--results-root", str(tmp_path), "--validate"]) == 0
    got = capsys.readouterr().out
    assert r_obs_main(["--results-root", str(tmp_path), "--validate"]) == 0
    assert got == capsys.readouterr().out
    assert "schema ok" in got and "run r1" in got


def test_cli_solve_shim_refuses_sharded(capsys):
    """The shim solves on ``sharded`` over a world of one rank, and refuses
    a mesh larger than the world, as the reference refuses more devices
    than its host has."""
    from repro_torch.parallel.mesh import destroy_owned_world

    small = ["--drugs", "20", "--diseases", "15", "--targets", "10", "--device", "cpu"]
    try:
        with pytest.warns(DeprecationWarning, match="repro_torch run"):
            assert tcli.main(["solve", "--backend", "sharded", "--devices", "1", *small]) == 0
        assert "[solve] backend: sharded" in capsys.readouterr().out
        with pytest.warns(DeprecationWarning, match="repro_torch run"):
            with pytest.raises(ValueError, match="needs 2 devices"):
                tcli.main(["solve", "--backend", "sharded", "--devices", "2", *small])
    finally:
        destroy_owned_world()


def test_cli_without_cuda_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["run", "--network", "drugnet", "--no-write"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


# ------------------------------------------------------- legacy subcommands


@pytest.mark.parametrize("name", ["solve", "serve", "scenario", "bench"])
def test_launch_module_entry_points_removed(name, capsys):
    mod = importlib.import_module(f"repro_torch.launch.{name}")
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"repro_torch.launch.{name} has been removed" in err
    assert "python -m repro_torch run" in err


TINY = ["--drugs", "30", "--diseases", "20", "--targets", "15"]


def test_solve_shim_matches_the_reference_shim(tmp_path):
    from repro.launch.cli import solve_main as ref_solve_main

    outs = []
    for main, extra in ((tcli.solve_main, ["--device", "cpu"]), (ref_solve_main, [])):
        out = str(tmp_path / f"shim{len(outs)}.npz")
        argv = TINY + ["--sigma", "1e-3", "--backend", "dense", "--top-k", "5", "--out", out]
        with pytest.warns(DeprecationWarning):
            assert main(argv + extra) == 0
        outs.append(np.load(out))
    for key in ("drug_target", "drug_disease", "sim_drug"):
        np.testing.assert_allclose(outs[0][key], outs[1][key], rtol=2e-4, atol=5e-4)
    assert list(np.argsort(-outs[0]["drug_target"][0], kind="stable")[:5]) == list(
        np.argsort(-outs[1]["drug_target"][0], kind="stable")[:5]
    )


def test_serve_and_scenario_shims(capsys):
    with pytest.warns(DeprecationWarning, match="repro_torch run"):
        assert tcli.serve_main(TINY + ["--requests", "6", "--max-batch", "4",
                                       "--engine", "kernel", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "queries" in out and "QPS" in out
    with pytest.warns(DeprecationWarning):
        assert tcli.scenario_main(["--solve", "bipartite", "--scale", "0.25",
                                   "--backends", "dense,sparse,kernel", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("agree_vs_dense=True") == 2
    with pytest.warns(DeprecationWarning):
        assert tcli.scenario_main(["--trace", "streaming", "--scale", "0.5",
                                   "--process", "diurnal", "--rate-qps", "30"]) == 0
    assert "deltas: 8" in capsys.readouterr().out.replace("  ", "")


def test_run_flags_build_the_references_spec(capsys):
    argv = ["--network", "scenario:streaming", "--scale", "0.5", "--seed-mode", "fixed",
            "--serve", "diurnal", "--rate-qps", "30", "--horizon", "2", "--dry-run"]
    assert tcli.run_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    from repro.launch.cli import run_main as ref_run_main

    assert ref_run_main(argv) == 0
    assert got == capsys.readouterr().out


# ------------------------------------------------------------------ imports


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.api, repro_torch.serve, repro_torch.launch.cli\n"
        "import repro_torch.scenarios.arrivals, repro_torch.obs\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.data.lm\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
