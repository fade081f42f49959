"""A cell on several ranks, and a traffic kind brought as a file.

Each test drives ``perfbench/run.py`` of a tiny checkout in a fresh
process, past its look for cards (``main(device="cpu")``): k > 1 ranks
meet over gloo.  Every test that starts ranks kills whatever it left
within its own time limit, and asserts that it left nothing.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from _tiny import ROOT, tiny_checkout

SEED = 4294967311
LIMIT_S = 240  # each test's own limit on a run


def _add_cell(co, name, *, chips, engine="kernel", kind="solve", kind_src=None, extra=None):
    """A cell of the tiny DHLP-2 solve on ``chips`` ranks, by files alone:
    its traffic (``engine``, ``kind``), its limits (the 1-chip cell's) and,
    given ``kind_src``, the kind's file."""
    pb = co / "perfbench"
    traffic = json.loads((pb / "traffic" / "dhlp2-solve.json").read_text())
    traffic.update(engine=engine, kind=kind, **(extra or {}))
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (pb / "cells" / f"{name}.json").write_text((pb / "cells" / "pl1m-dhlp2-solve.json").read_text())
    if kind_src is not None:
        (pb / "kinds").mkdir(exist_ok=True)
        (pb / "kinds" / f"{kind}.py").write_text(textwrap.dedent(kind_src))
    b = json.loads((co / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": name, "config": "drugnet-powerlaw-1m", "traffic": name,
                           "chips": chips, "why": "w"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "pl1m-dhlp2-solve" in m.get("workloads", ()):
            m["workloads"].append(name)
    (co / "BENCHMARK.json").write_text(json.dumps(b))


def _alive(token):
    """Pids of the processes whose command line holds ``token``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if token.encode() in cmd:
            found.append(int(pid))
    return found


def _in_process(co, code):
    """``code`` run with checkout ``co`` as its directory, in a fresh
    process; returns (the completed process, pids of it or its ranks still
    alive, which are then killed)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    try:
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, cwd=co, timeout=LIMIT_S)
    finally:
        time.sleep(0.5)  # a killed rank's exit reaches /proc
        left = _alive(str(co))
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    return res, left


def _run(co, workload, *, trace=0, seconds=0.5, before="", after=""):
    """``run.py`` of checkout ``co`` in a fresh process, ``before`` and
    ``after`` run around it there (``before`` may set ``world.WALL_S``)."""
    return _in_process(co, textwrap.dedent(before) + textwrap.dedent(f"""
        import sys, runpy
        sys.path[:0] = [{str(ROOT / 'src')!r}]
        mod = runpy.run_path({str(co / 'perfbench' / 'run.py')!r})
        rc = mod["main"](["--workload", {workload!r}, "--seed", "{SEED}", "--seconds",
                          "{seconds}", "--trace", "{trace}"], device="cpu")
    """) + textwrap.dedent(after) + "sys.exit(rc)\n")


def _result(res):
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and res.stdout.strip().splitlines()[-1] == lines[0]
    return json.loads(lines[0])


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_four_rank_cell_prints_one_result_from_rank_0(trace_on, tmp_path):
    """The ``sharded`` engine over a world of four gloo ranks, through
    ``run.py``: one result line, ``device.count`` 4, correct."""
    co = tiny_checkout(tmp_path / "co")
    _add_cell(co, "pl1m-dhlp2-sharded4", chips=4, engine="sharded")
    res, left = _run(co, "pl1m-dhlp2-sharded4", trace=trace_on)
    out = _result(res)
    assert left == []
    assert out["correct"], out["check"]
    dev = out["device"]
    assert dev["count"] == 4 and [r["rank"] for r in dev["ranks"]] == [0, 1, 2, 3]
    assert dev["memory_peak_bytes"] == max(r["memory_peak_bytes"] for r in dev["ranks"])
    if trace_on:
        assert all(r["window_s"] > 0 for r in dev["ranks"])
        assert dev["window_s"] == dev["ranks"][0]["window_s"]
        assert out["metrics"]["solve.rounds"]["value"] >= 1
    else:
        assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert res.stderr.strip().splitlines()[-1].startswith("check ")


_SLOW_RANK = """
    import time
    from pathlib import Path

    import torch.distributed as dist

    from perfbench.harness.cells import SolveLoop


    class Loop(SolveLoop):
        '''The solve kind, each call of rank 1 made slower on purpose; each
        rank writes how many calls its window made.'''

        def solve_once(self, *a):
            out = super().solve_once(*a)
            if dist.get_rank() == 1:
                time.sleep(0.15)
            return out

        def window(self, seconds, tracer, done=None):
            status = super().window(seconds, tracer, done)
            Path(self.traffic["calls_dir"], f"rank{dist.get_rank()}").write_text(str(self.solves))
            return status
"""


def test_every_rank_makes_the_calls_rank_0_decides(tmp_path):
    """Rank 1 slower than the rest, on an engine with no collective to hold
    the ranks together: every rank still makes the same number of calls."""
    co = tiny_checkout(tmp_path / "co")
    calls = tmp_path / "calls"
    calls.mkdir()
    _add_cell(co, "stub-slow", chips=4, kind="stub_slow", kind_src=_SLOW_RANK,
              extra={"calls_dir": str(calls)})
    res, left = _run(co, "stub-slow", seconds=3.0)  # several calls, even on a busy host
    out = _result(res)
    assert left == [] and out["correct"], out["check"]
    made = {p.name: int(p.read_text()) for p in calls.iterdir()}
    assert sorted(made) == ["rank0", "rank1", "rank2", "rank3"]
    assert set(made.values()) == {out["attempted"]} and out["attempted"] >= 2


_FAULTY_RANK = """
    import time

    import torch.distributed as dist

    from perfbench.harness.cells import SolveLoop


    class Loop(SolveLoop):
        def __init__(self, *a):
            super().__init__(*a)
            if dist.get_rank() == 1 and self.traffic["fault"] == "raise":
                raise RuntimeError("planted fault of rank 1")

        def solve_once(self, *a):
            if dist.get_rank() == 1 and self.traffic["fault"] == "block" and hasattr(self, "rounds"):
                time.sleep(3600)  # in the window: the others wait in a collective
            return super().solve_once(*a)
"""


def test_a_rank_that_raises_ends_the_run(tmp_path):
    co = tiny_checkout(tmp_path / "co")
    _add_cell(co, "stub-raise", chips=4, engine="sharded", kind="stub_faulty",
              kind_src=_FAULTY_RANK, extra={"fault": "raise"})
    res, left = _run(co, "stub-raise")
    assert res.returncode == 5 and res.stdout.strip() == "", res.stderr[-3000:]
    assert "planted fault of rank 1" in res.stderr
    assert res.stderr.strip().splitlines()[-1].startswith("rank 1 of 4 exited with 1")
    assert left == []


def test_a_rank_that_blocks_is_killed_at_the_wall_clock_limit(tmp_path):
    co = tiny_checkout(tmp_path / "co")
    _add_cell(co, "stub-block", chips=4, engine="sharded", kind="stub_faulty",
              kind_src=_FAULTY_RANK, extra={"fault": "block"})
    t0 = time.monotonic()
    res, left = _run(co, "stub-block", seconds=60,
                     before="from perfbench.harness import world\nworld.WALL_S = 30.0\n")
    assert res.returncode == 5 and res.stdout.strip() == "", res.stderr[-3000:]
    assert time.monotonic() - t0 < 30 + 20
    assert "passed its wall-clock limit of 30.0 s" in res.stderr.strip().splitlines()[-1]
    assert left == []


_JAX_ON_RANK_1 = """
    import sys

    import torch.distributed as dist

    from perfbench.harness.cells import SolveLoop


    class Loop(SolveLoop):
        '''The solve kind, rank 1 importing a top-level ``jax`` once its
        window has closed.'''

        def window(self, seconds, tracer, done=None):
            status = super().window(seconds, tracer, done)
            if dist.get_rank() == 1:
                sys.path.insert(0, self.traffic["stub_dir"])
                import jax  # noqa: F401
            return status
"""


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_rank_that_loads_jax_leaves_no_result(trace_on, tmp_path):
    """Rank 1 alone holds ``jax`` after the window: ``run.py`` exits 3, prints
    no result, and names the module and the rank."""
    co = tiny_checkout(tmp_path / "co")
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    _add_cell(co, "stub-jax", chips=4, engine="sharded", kind="stub_jax",
              kind_src=_JAX_ON_RANK_1, extra={"stub_dir": str(tmp_path / "stub")})
    res, left = _run(co, "stub-jax", trace=trace_on)
    assert res.returncode == 3, res.stderr[-3000:]
    assert res.stdout.strip() == "" and left == []
    assert res.stderr.strip().splitlines()[-1].endswith("jax (rank 1)")


_TOLD = """
    from pathlib import Path

    import torch.distributed as dist

    from perfbench.harness.cells import SolveLoop


    class Loop(SolveLoop):
        '''The solve kind; each rank writes whether it was told to run the control.'''

        def __init__(self, config, traffic, seed, device, control=False):
            super().__init__(config, traffic, seed, device, control)
            Path(traffic["told_dir"], f"{seed}.rank{dist.get_rank()}").write_text(str(control))
"""


def test_calibrate_reads_a_four_rank_cell_and_its_control(tmp_path):
    """``calibrate.py`` on a cell of four ranks: one line for each seed, every
    rank told whether it runs the control, and the control's numbers over
    the cell's limits where the program's are under them.  (The ``kernel``
    engine on every rank: the ``sharded`` engine has no bfloat16 path.)"""
    co = tiny_checkout(tmp_path / "co")
    told = tmp_path / "told"
    told.mkdir()
    _add_cell(co, "stub-told", chips=4, kind="stub_told", kind_src=_TOLD,
              extra={"told_dir": str(told)})
    res, left = _in_process(co, textwrap.dedent(f"""
        import sys, runpy
        sys.path[:0] = [{str(ROOT / 'src')!r}]
        mod = runpy.run_path({str(co / 'perfbench' / 'calibrate.py')!r})
        sys.exit(mod["main"](["--workload", "stub-told", "--seeds", "{SEED}",
                              "--control-seeds", "{SEED + 1}", "--seconds", "0.5"],
                             device="cpu"))
    """))
    assert res.returncode == 0 and left == [], res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert [(ln["seed"], ln["control"]) for ln in lines] == [(SEED, False), (SEED + 1, True)]
    assert {p.name: p.read_text() for p in told.iterdir()} == {
        **{f"{SEED}.rank{r}": "False" for r in range(4)},
        **{f"{SEED + 1}.rank{r}": "True" for r in range(4)}}
    limits = json.loads((co / "perfbench" / "cells" / "stub-told.json").read_text())["limits"]
    program, control = (ln["numbers"] for ln in lines)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(float(control[k]) > lim for k, lim in limits.items()), control
    assert all(ln["attempted"] >= 1 and ln["setup_s"] > 0 for ln in lines)


_RANGED = """
    from perfbench.harness.cells import SolveLoop

    RANGES = ("stub.call",)


    class Loop(SolveLoop):
        '''The solve kind, each call inside a range of its own.'''

        def solve_once(self, tracer=None):
            if tracer is None:
                return super().solve_once()
            with tracer.span("stub.call"):
                return super().solve_once(tracer)
"""


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_kind_from_a_file_runs_with_its_ranges(trace_on, tmp_path):
    """``perfbench/kinds/<kind>.py`` with its own ``RANGES``, and a reader
    of that range, added as files: ``run.py`` runs it, no file that was
    there changed."""
    co = tiny_checkout(tmp_path / "co")
    before = {p: p.read_bytes() for p in (co / "perfbench").rglob("*") if p.is_file()}
    _add_cell(co, "stub-ranged", chips=1, kind="stub_ranged", kind_src=_RANGED)
    (co / "perfbench" / "metrics" / "stub.calls.py").write_text(
        "def read(ctx):\n    n = ctx.trace.span_count('stub.call') if ctx.trace else 0\n"
        "    return n or None\n")
    b = json.loads((co / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "stub.calls", "unit": "calls", "better": "higher",
                           "source": "program_span", "layer": "entry / engine",
                           "moves": "solve_s", "workloads": ["stub-ranged"]})
    (co / "BENCHMARK.json").write_text(json.dumps(b))
    res, left = _run(co, "stub-ranged", trace=trace_on)
    out = _result(res)
    assert left == [] and out["correct"], out["check"]
    if trace_on:
        assert out["metrics"]["stub.calls"]["value"] == out["attempted"]
        assert "ranks" not in out["device"]
    else:
        assert set(out["metrics"]) == {"solve_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_an_unknown_kind_names_the_file_it_looked_for(tmp_path):
    co = tiny_checkout(tmp_path / "co")
    _add_cell(co, "stub-unknown", chips=1, kind="no_such_kind")
    res, left = _run(co, "stub-unknown")
    assert res.returncode == 6 and res.stdout.strip() == "" and left == []
    assert str(co / "perfbench" / "kinds" / "no_such_kind.py") in res.stderr


def test_a_one_chip_cell_starts_no_rank_and_opens_no_world(tmp_path):
    """No second process of ``run.py`` (the C library's lookup for the host
    settings may run ``ldconfig``) and no process group."""
    co = tiny_checkout(tmp_path / "co")
    res, left = _run(co, "pl1m-dhlp2-solve", before="""
        import subprocess
        started = []
        class Spy(subprocess.Popen):
            def __init__(self, *a, **kw):
                started.append(str(a[0] if a else kw.get("args")))
                super().__init__(*a, **kw)
        subprocess.Popen = Spy
    """, after="""
        import torch.distributed as dist
        print("ranks", sum("run.py" in c for c in started), "world", dist.is_initialized())
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-2])["correct"]
    assert res.stdout.strip().splitlines()[-1] == "ranks 0 world False"
    assert left == []


class _Event:
    """One event of a profiler's trace, as ``trace.read`` sees it."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self._v = (name, start, end, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_the_trace_reader_drops_device_annotations_and_keeps_a_kinds_ranges():
    """Host ranges mirrored on the device (the benchmark's, a kind's, a
    collective's ``nccl:all_reduce``) are no device work; a kind's own
    range is a span of the trace."""
    from types import SimpleNamespace

    from perfbench.harness import trace

    events = [_Event("window", 0, 100), _Event("stub.call", 10, 60),
              _Event("stub.call", 10, 60, device=True, annotation=True),
              _Event("nccl:all_reduce", 20, 50, device=True, annotation=True),
              _Event("ncclDevKernel_AllReduce", 20, 50, device=True),
              _Event("Memcpy HtoD", 70, 80, device=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = trace.read(prof, trace.Tracer(True, ("stub.call",)).ranges)
    assert tr.dev_name == ["ncclDevKernel_AllReduce", "Memcpy HtoD"]
    assert tr.busy_s == 40e-9 and tr.kernel_seconds_in("stub.call") == 30e-9
    assert tr.span_count("stub.call") == 1 and tr.window == (0, 100)
    with pytest.raises(ValueError, match="unknown range"):
        trace.Tracer(True).span("stub.call")
