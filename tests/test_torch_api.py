"""Port API and CLI vs the JAX reference: RunSpec, Session, ``python -m
repro_torch``.

The schema is shared: every committed spec and every RunSpec block of the
docs parses to the same ``to_dict()`` and content hash in both packages.
The quickstart spec without its ``obs`` section (the port's entry-point
gate) runs through ``Session.run`` in both packages — equal solve ranking
and ``outer_iters``, recovery metrics within 5e-3 — and through ``python
-m repro_torch run --device cpu`` as a subprocess.  Every section whose
modules are not ported raises ``NotImplementedError`` naming its item of
``ROADMAP.md``'s queue A; nothing falls back to the CPU unasked.
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


# ------------------------------------------------------- not ported: named


NOT_PORTED_SPECS = [
    ("obs_metrics", {"obs": {"level": "metrics"}}, "A.4"),
    ("obs_slo", {"obs": json.loads(QUICKSTART.read_text())["obs"]}, "A.4"),
    ("ft", {"ft": {"interval": 2}}, "A.5"),
    ("bench", {"bench": {"suites": ["lp_matrix"]}}, "A.6"),
    ("train", {"train": {"arch": "gcn-cora", "steps": 2}}, "A.9"),
    ("dryrun", {"dryrun": {}}, "A.9"),
    ("sharded", {"solve": {"backend": "sharded", "devices": 1, "seed_mode": "fixed"}}, "A.8"),
]


@pytest.mark.parametrize(
    "overrides,item", [p[1:] for p in NOT_PORTED_SPECS], ids=[p[0] for p in NOT_PORTED_SPECS]
)
def test_unported_sections_raise_and_name_their_item(tmp_path, overrides, item):
    d = _quickstart_without_obs()
    d.update(overrides)
    spec = ta.RunSpec.from_dict(d)
    session = ta.Session(spec, results_root=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match=f"queue {item}"):
        session.run()
    assert not (tmp_path / spec.resolved_run_id()).exists()  # nothing written
    # and through the CLI: exit 2, the message on stderr
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(d))
    assert tcli.main(["run", str(path), "--device", "cpu", "--no-write"]) == 2


def test_unported_stage_methods_name_their_item():
    spec = ta.RunSpec.from_dict(_quickstart_without_obs())
    session = ta.Session(spec, device="cpu")
    for call, item in ((session.bench, "A.6"), (session.train, "A.9"), (session.dryrun, "A.9")):
        with pytest.raises(NotImplementedError, match=f"queue {item}"):
            call()


@pytest.mark.parametrize("stage", ["solve", "serve_engine", "serve"])
def test_ft_section_raises_on_each_stage_called_alone(stage):
    d = _quickstart_without_obs()
    d["ft"] = {"interval": 2}
    session = ta.Session(ta.RunSpec.from_dict(d), device="cpu")
    with pytest.raises(NotImplementedError, match="queue A.5"):
        getattr(session, stage)()


@pytest.mark.parametrize(
    "argv,item",
    [
        ([str(QUICKSTART), "--device", "cpu"], "A.4"),
        (["--resume", "quickstart"], "A.5"),
        (["--network", "drugnet", "--bench", "--device", "cpu", "--no-write"], "A.6"),
        (["--network", "drugnet", "--obs", "--device", "cpu", "--no-write"], "A.4"),
    ],
    ids=["full_quickstart", "resume", "run_bench", "run_obs"],
)
def test_cli_run_names_the_queue_item(capsys, argv, item):
    assert tcli.main(["run"] + argv) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP.md queue {item}" in err


@pytest.mark.parametrize("cmd,item", [("obs", "A.4"), ("bench", "A.6")])
def test_cli_unported_subcommands(capsys, cmd, item):
    assert tcli.main([cmd]) == 2
    assert f"ROADMAP.md queue {item}" in capsys.readouterr().err


def test_cli_solve_shim_refuses_sharded(capsys):
    with pytest.warns(DeprecationWarning, match="repro_torch run"):
        with pytest.raises(SystemExit) as exc:  # a usage error, as in the reference
            tcli.main(["solve", "--backend", "sharded", "--devices", "1", "--device", "cpu"])
    assert exc.value.code == 2
    assert "queue A.8" in capsys.readouterr().err


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
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax'))"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
