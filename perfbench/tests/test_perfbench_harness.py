"""The harness itself: BENCHMARK.json against the contract, discovery by
files alone, the JAX-free run, the reference's imports, the trace reader,
the roofline counts."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _tiny import CELLS, ROOT, shrink, tiny_cell, tiny_checkout

from perfbench.harness import host, roofline, runner, spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    n = len(b["workloads"])
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in b["workloads"]]
    for c in cells:
        mine = [m["name"] for m in b["end_to_end"] if c in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells), (m["name"], c)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(set(n for n in [*names, *cells, *e2e, *(m["name"] for m in b["per_layer"])])) == (
        len(names) + n + len(e2e) + len(b["per_layer"]))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = spec.load_cell(ROOT, name)
    assert cell.limits and cell.config["reduced"] == []
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


def test_a_new_configuration_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a traffic mix, a cell, an
    end-to-end metric and a per-layer metric as new files and entries: the
    harness finds them and runs the cell, and no file that was there
    changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "drugnet-powerlaw-1m.json").read_text())
    cfg["name"] = "drugnet-powerlaw-2m"
    cfg["generator"]["target_edges"] = 3400000
    del cfg["host"]  # a deployment under glibc's defaults
    (pb / "configs" / "drugnet-powerlaw-2m.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "dhlp2-solve.json").read_text())
    traffic.update(top_k=50, metric="solve_top50_s")
    (pb / "traffic" / "dhlp2-solve-top50.json").write_text(json.dumps(traffic))
    limits = json.loads((pb / "cells" / "pl1m-dhlp2-solve.json").read_text())["limits"]
    (pb / "cells" / "pl2m-dhlp2-top50.json").write_text(json.dumps({"limits": limits}))
    (pb / "metrics" / "solve.column_rounds_max.py").write_text(
        "def read(ctx):\n    c = ctx.counters.get('solve.column_rounds')\n"
        "    return max(int(r.max()) for r in c) if c else None\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "drugnet-powerlaw-2m", "source": "s", "reduced": [], "why": "w",
                         "file": "perfbench/configs/drugnet-powerlaw-2m.json"})
    b["workloads"].append({"name": "pl2m-dhlp2-top50", "config": "drugnet-powerlaw-2m",
                           "traffic": "dhlp2-solve-top50", "chips": 1, "why": "w"})
    b["end_to_end"].insert(0, {"name": "solve_top50_s", "unit": "s", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["pl2m-dhlp2-top50"]})
    b["per_layer"].append({"name": "solve.column_rounds_max", "unit": "rounds",
                           "better": "lower", "source": "program_counter",
                           "layer": "entry / engine", "moves": "solve_top50_s",
                           "workloads": ["pl2m-dhlp2-top50"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell(tmp_path, "pl2m-dhlp2-top50")
    assert cell.config["generator"]["target_edges"] == 3400000
    assert cell.traffic["top_k"] == 50
    assert [m["name"] for m in cell.end_to_end] == ["solve_top50_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["solve.column_rounds_max"]
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])  # jax may share this process
    tiny = shrink(cell)
    out = runner.run(tiny, seed=5, seconds=0.2, traced=False, device="cpu", t0=0.0)
    assert out["correct"] and set(out["metrics"]) == {"solve_top50_s", "setup_s"}
    out = runner.run(tiny, seed=5, seconds=0.2, traced=True, device="cpu", t0=0.0)
    assert out["correct"] and out["metrics"]["solve.column_rounds_max"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _run_py(checkout, workload, *, trace=0, stub=None, seconds=0.2):
    """``perfbench/run.py`` of ``checkout`` in a fresh process, past its look
    for a card (``main(device="cpu")``); ``stub`` goes first on the path."""
    code = textwrap.dedent(f"""
        import sys, runpy
        sys.path[:0] = {[str(stub)] if stub else []!r} + [{str(ROOT / 'src')!r}]
        mod = runpy.run_path({str(checkout / 'perfbench' / 'run.py')!r})
        sys.exit(mod["main"](["--workload", {workload!r}, "--seed", "4294967311",
                              "--seconds", "{seconds}", "--trace", "{trace}"], device="cpu"))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=checkout, timeout=300)


@pytest.mark.parametrize("name, trace_on", [(c, 0) for c in CELLS] + [("pl1m-dhlp2-solve", 1)])
def test_a_run_loads_no_jax_and_no_jax_package(name, trace_on, tmp_path):
    """A whole tiny run of ``run.py`` in a fresh process: it prints its
    result, so by then it held no top-level ``jax``, ``jaxlib``, ``flax``
    or ``repro`` (compared whole: ``repro_torch`` is the port)."""
    res = _run_py(tiny_checkout(tmp_path), name, trace=trace_on)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "check"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """A per-layer reader (a file a later change may add) that imports a
    top-level ``jax`` after the window has closed: ``run.py`` exits 3,
    prints no result, and names the module."""
    co = tiny_checkout(tmp_path / "co")
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (co / "perfbench" / "metrics" / "stub.loads_jax.py").write_text(
        "def read(ctx):\n    import jax  # noqa: F401\n    return None\n")
    b = json.loads((co / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "stub.loads_jax", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "solve_s",
                           "workloads": ["pl1m-dhlp2-solve"]})
    (co / "BENCHMARK.json").write_text(json.dumps(b))
    res = _run_py(co, "pl1m-dhlp2-solve", trace=1, stub=tmp_path / "stub")
    assert res.returncode == 3, res.stderr[-3000:]
    assert res.stdout.strip() == "" and "jax" in res.stderr.strip().splitlines()[-1]


def test_a_host_setting_the_library_refuses_leaves_no_result(tmp_path):
    co = tiny_checkout(tmp_path / "co")
    path = co / "perfbench" / "configs" / "drugnet-powerlaw-1m.json"
    cfg = json.loads(path.read_text())
    cfg["host"]["mallopt"]["M_NOT_A_PARAMETER"] = 1
    path.write_text(json.dumps(cfg))
    res = _run_py(co, "pl1m-dhlp2-solve")
    assert res.returncode == 4 and res.stdout.strip() == ""
    assert "M_NOT_A_PARAMETER" in res.stderr


class _Mallopt:
    """A C library's ``mallopt`` that answers ``answer`` to every call."""

    def __init__(self, answer):
        self.answer, self.calls = answer, []

    def __call__(self, param, value):
        self.calls.append((param, value))
        return self.answer


@pytest.mark.parametrize("answer", [1, 0])
def test_host_settings_are_applied_or_refused(answer, monkeypatch):
    fn = _Mallopt(answer)
    monkeypatch.setattr(host.ctypes, "CDLL", lambda name: type("Lib", (), {"mallopt": fn})())
    cfg = {"host": {"mallopt": {"M_MMAP_THRESHOLD": 1 << 30, "M_TRIM_THRESHOLD": 2**31 - 1}}}
    if answer == 1:
        assert host.apply(cfg) == cfg["host"]["mallopt"]
        assert fn.calls == [(-3, 1 << 30), (-1, 2**31 - 1)]
    else:
        with pytest.raises(host.HostSettingRefused, match="M_MMAP_THRESHOLD"):
            host.apply(cfg)
    assert host.apply({}) == {} and host.apply({"host": {}}) == {}


def test_every_configuration_states_its_host_settings():
    """The allocator setting is the configurations' own, with its source."""
    for c in _bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["host"]["mallopt"]) <= set(host.MALLOPT)
        assert cfg["host"]["source"].startswith("https://")


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] if node.level == 0 else ["perfbench"]
            else:
                continue
            for top in tops:
                assert top not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), (path, top)
                assert top in ("__future__", "typing", "numpy", "torch", "math"), (path, top)


def test_run_without_a_card_exits_without_a_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "pl1m-dhlp2-solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert res.returncode == 2 and res.stdout.strip() == ""


def test_trace_union_gaps_and_spans():
    ms = 1_000_000
    tr = trace.Trace(
        dev_name=["k1", "k2", "Memcpy HtoD", "k1"],
        dev_kind=np.asarray(["kernel", "kernel", "memcpy", "kernel"], dtype="U8"),
        dev_start=np.asarray([1, 2, 6, 20], dtype=np.int64) * ms,
        dev_end=np.asarray([3, 4, 8, 30], dtype=np.int64) * ms,
        spans={"window": (np.asarray([0]), np.asarray([40 * ms])),
               "solve": (np.asarray([0, 19 * ms]), np.asarray([5 * ms, 25 * ms]))},
        host_name=["window", "solve", "aten::sort"],
        host_start=np.asarray([0, 19 * ms, 9 * ms], dtype=np.int64),
        host_end=np.asarray([40 * ms, 25 * ms, 19 * ms], dtype=np.int64),
        window=(0, 40 * ms),
    )
    assert tr.busy_s == pytest.approx((3 + 2 + 10) / 1e3)
    assert tr.kernel_seconds_in("solve") == pytest.approx((2 + 2 + 10) / 1e3)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(0.012)]
    assert bd["idle_gaps"][0] == ["aten::sort", pytest.approx(0.012)]
    assert bd["idle_gaps"][1] == ["window", pytest.approx(0.010)]


def test_roofline_counts_each_byte_once():
    c = roofline.lp_round(n=10, nnz=40, s=3, residual=True, base_is_f=False)
    assert c["flops"] == 2 * 40 * 3 + 4 * 10 * 3
    assert c["bytes"] == 8 * 40 + 4 * 11 + 3 * 4 * 10 * 3 + 4 * 3
    least = roofline.least_seconds(c, {"flops": 1.0, "bytes_per_s": 1.0})
    assert least["seconds"] == max(c["flops"], c["bytes"])


def test_cells_fit_the_check_budget():
    """A full check of 24 cells at run_seconds fits a full check's 43,200 s."""
    rs = _bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert tiny_cell("pl1m-dhlp2-solve").chips == 1
