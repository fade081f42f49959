"""The readers of the program's own ranges (``lp.*``, ``bio.*``): exact on
synthetic traces, silent where the ranges are absent, and read in tiny
traced runs of every cell on the CPU."""

import numpy as np
import pytest

from _tiny import CELLS, ROOT, tiny_cell

from perfbench.harness import cells, runner, spans, spec, trace

MS = 1_000_000
SOLVE_READERS = ("rank.extract_ms", "rank.topk_ms", "solve.seed_ms", "solve.halt_wait_ms",
                 "solve.download_ms", "device.idle.named.solve")
BIO_READERS = ("bio.plan_ms", "bio.plan.bucket_ms", "device.idle.named.bio")
SEED = 2**31 + 17


def _trace(busy, host, spans_, window=(0, 100)):
    """A trace of device blocks ``busy`` and host events ``host`` (name,
    start, end), in ms; ``spans_`` the benchmark's ranges by name."""
    return trace.Trace(
        dev_name=["k"] * len(busy),
        dev_kind=np.asarray(["kernel"] * len(busy), dtype="U8"),
        dev_start=np.asarray([s for s, _ in busy], dtype=np.int64) * MS,
        dev_end=np.asarray([e for _, e in busy], dtype=np.int64) * MS,
        spans={k: (np.asarray([s for s, _ in v], dtype=np.int64) * MS,
                   np.asarray([e for _, e in v], dtype=np.int64) * MS)
               for k, v in spans_.items()},
        host_name=[n for n, _, _ in host],
        host_start=np.asarray([s for _, s, _ in host], dtype=np.int64) * MS,
        host_end=np.asarray([e for _, _, e in host], dtype=np.int64) * MS,
        window=(window[0] * MS, window[1] * MS),
    )


def _solve_trace(program=True):
    """Two solves in a 100 ms window; the card busy 10-20, 30-40, 60-70, so
    idle 0-10, 20-30, 40-60, 70-100 (70 ms).  The program's ranges cover
    3 + 5 + 10 + 18 + 2 ms of it; ``aten::sort`` and ``rank`` are not the
    program's, and the last ``lp.topk`` runs past the window's end."""
    prog = [("lp.seeds", 2, 5), ("lp.upload", 5, 12), ("lp.round", 12, 38), ("lp.halt", 25, 28),
            ("lp.download", 41, 45), ("lp.extract", 45, 55), ("lp.topk", 55, 57),
            ("lp.topk", 57, 58), ("lp.topk", 58, 59), ("lp.topk", 98, 103)]
    host = [("window", 0, 100), ("solve", 1, 45), ("rank", 45, 59), ("aten::sort", 80, 90)]
    return _trace([(10, 20), (30, 40), (60, 70)], host + (prog if program else []),
                  {"window": [(0, 100)], "solve": [(1, 45), (60, 97)], "rank": [(45, 59)]})


def _bio_trace(program=True):
    """One step: the plan 10-90 (edges down 10-20, bucketing 20-70, buckets
    up 70-90); the card busy 12-18, 75-88, 92-99, so idle 74 ms, 61 of it
    inside the plan."""
    prog = [("bio.plan", 10, 90), ("bio.plan.download", 10, 20), ("bio.plan.bucket", 20, 70),
            ("bio.plan.upload", 70, 90)]
    host = [("window", 0, 100), ("step", 5, 99)]
    return _trace([(12, 18), (75, 88), (92, 99)], host + (prog if program else []),
                  {"window": [(0, 100)], "step": [(5, 99)]})


def _read(metric, tr):
    cell = "bio20m-step" if metric in BIO_READERS else "pl1m-dhlp2-solve"
    return spec.load_cell(ROOT, cell).reader(metric)(runner.Context(trace=tr, counters={},
                                                                    peaks=None))


@pytest.mark.parametrize("metric, want", [
    ("rank.extract_ms", 10 / 2), ("rank.topk_ms", (2 + 1 + 1 + 2) / 2),
    ("solve.seed_ms", (3 + 7) / 2), ("solve.halt_wait_ms", 3 / 2), ("solve.download_ms", 4 / 2),
    ("device.idle.named.solve", 100 * 38 / 70),
])
def test_solve_readers_on_a_synthetic_trace(metric, want):
    assert _read(metric, _solve_trace()) == pytest.approx(want, rel=1e-12)
    assert _read(metric, _solve_trace(program=False)) is None
    assert _read(metric, _bio_trace()) is None or metric.startswith("device.")


@pytest.mark.parametrize("metric, want", [
    ("bio.plan_ms", 80.0), ("bio.plan.bucket_ms", 50.0), ("device.idle.named.bio", 100 * 61 / 74),
])
def test_bio_readers_on_a_synthetic_trace(metric, want):
    assert _read(metric, _bio_trace()) == pytest.approx(want, rel=1e-12)
    assert _read(metric, _bio_trace(program=False)) is None
    assert _read(metric, None) is None


def test_named_idle_counts_a_gap_only_where_a_range_overlaps_it():
    # one range inside a busy block, one across a gap's end: only the
    # part of the second inside the gap counts
    tr = _trace([(10, 50)], [("window", 0, 100), ("lp.round", 20, 30), ("lp.topk", 40, 60)],
                {"window": [(0, 100)]})
    assert spans.named_idle_share(tr) == pytest.approx(100 * 10 / 60)
    # no device event at all: no idle time to name
    empty = _trace([], [("window", 0, 100), ("lp.round", 20, 30)], {"window": [(0, 100)]})
    assert spans.named_idle_share(empty) is None
    # ranges that overlap each other are counted once
    tr = _trace([(90, 100)], [("window", 0, 100), ("lp.round", 0, 50), ("lp.halt", 10, 20),
                              ("lp.topk", 40, 70)], {"window": [(0, 100)]})
    assert spans.named_idle_share(tr) == pytest.approx(100 * 70 / 90)


def _traced_window(name, monkeypatch):
    """A tiny cell's window under the tracer, read: (the cell's loop, the trace)."""
    if name == "bio20m-step":  # the step's card route (lp_plan) on plain ops
        from repro_torch.configs import dhlp_bio
        monkeypatch.setattr(dhlp_bio, "on_cpu", lambda *a: False)
    cell = tiny_cell(name)
    drv = cells.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, SEED, "cpu")
    tracer = trace.Tracer(True)
    with tracer.window():
        drv.window(0.3, tracer)
    return drv, trace.read(tracer.prof)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reads_the_program_ranges(name, monkeypatch):
    drv, tr = _traced_window(name, monkeypatch)
    ctx = runner.Context(trace=tr, counters=drv.counters(), peaks=None)
    cell = tiny_cell(name)
    mine = [m["name"] for m in cell.per_layer if m["source"] == "program_span"]
    assert set(mine) == set(BIO_READERS if name == "bio20m-step" else SOLVE_READERS)
    for metric in mine:
        value = cell.reader(metric)(ctx)
        if metric.startswith("device."):
            assert value is None  # no device events on the CPU
        else:
            assert value is not None and value > 0, metric
    if name == "bio20m-step":
        idx = spans.ranges(tr)
        assert idx["bio.plan"][0].size == tr.span_count("step") == drv.steps
        plan = idx["bio.plan"][1] - idx["bio.plan"][0]
        parts = sum(idx[p][1] - idx[p][0] for p in
                    ("bio.plan.download", "bio.plan.bucket", "bio.plan.upload"))
        assert (parts <= plan).all()
    else:
        idx = spans.ranges(tr)
        assert idx["lp.round"][0].size == sum(drv.rounds)
        assert idx["lp.download"][0].size == tr.span_count("solve") == drv.solves


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reports_them(name, monkeypatch):
    """Through ``runner.run``, as ``perfbench/run.py`` drives it."""
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])
    if name == "bio20m-step":
        from repro_torch.configs import dhlp_bio
        monkeypatch.setattr(dhlp_bio, "on_cpu", lambda *a: False)
    out = runner.run(tiny_cell(name), seed=SEED, seconds=0.3, traced=True, device="cpu", t0=0.0)
    assert out["correct"], out["check"]
    want = BIO_READERS if name == "bio20m-step" else SOLVE_READERS
    assert set(out["metrics"]) >= {m for m in want if not m.startswith("device.")}
