"""The hot-path spans of ``repro_torch.obs.profiler.hot_span``, on the CPU.

Under ``torch.profiler`` the engines' loops, the ranking and the
``dhlp-bio`` plan build leave ``_RecordFunctionFast`` ranges by name
(plain CPU events, never user annotations); with a ``Telemetry``
installed as the collector the same names land in its events, parented;
with neither, ``hot_span`` is the shared no-op span.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.obs as to
import repro_torch.scenarios as ts
from repro_torch.configs import dhlp_bio
from repro_torch.obs import profiler as tprof
from repro_torch.obs.schema import validate_line
from repro_torch.obs.telemetry import _NULL_SPAN

SOLVE_SPANS = ("lp.seeds", "lp.upload", "lp.round", "lp.halt", "lp.download", "lp.extract",
               "lp.topk")
PLAN_PARTS = ("bio.plan.download", "bio.plan.bucket", "bio.plan.upload")
PAIR = (0, 2)


@pytest.fixture(scope="module")
def net():
    return ts.generate("powerlaw", scale=0.03, seed=0, cache=False).network


def _engine(alg, backend=None, fused=True):
    backend = backend or ("kernel" if alg == "dhlp2" else "sparse")
    cfg = tc.LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed", max_inner=50)
    return te.make_engine(backend, cfg, device="cpu", fused_superstep=fused)


def _solve_and_rank(eng, net):
    """An all-sources solve, then every source's top 10 of the pair."""
    res = eng.run(net)
    block = tc.extract_outputs(res.F, net.normalize()).interactions[PAIR]
    known = net.R[PAIR] > 0
    tops = [tc.topk_exclusive(block[d], 10, known[d]) for d in range(block.shape[0])]
    return res, tops


def _ranges(prof):
    """The program's ranges of a finished profile: name -> [(start, end,
    is_user_annotation)]."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(("lp.", "bio.")):
            out.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.is_user_annotation()))
    return out


def _bio_inputs(n=400, e=3000, s=6, seed=0):
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    w = torch.as_tensor(rng.random(e) / 8, dtype=torch.float32)
    Y = torch.zeros(n, s)
    Y[torch.arange(s), torch.arange(s)] = 1.0
    return src, dst, w, Y


def test_hot_span_is_the_shared_no_op_when_nothing_records():
    assert tprof._COLLECTOR is None
    assert tprof.hot_span("lp.round") is _NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert tprof.hot_span("lp.round") is not _NULL_SPAN
    assert tprof.hot_span("lp.topk") is _NULL_SPAN


@pytest.mark.parametrize("alg, backend, fused", [
    pytest.param("dhlp2", "kernel", True, id="dhlp2"),
    pytest.param("dhlp1", "sparse", True, id="dhlp1"),
    pytest.param("dhlp2", "sparse", True, id="dhlp2-sparse"),
    # the node-order loops (fused_superstep=False) open the same ranges
    pytest.param("dhlp2", "kernel", False, id="dhlp2-kernel-legacy"),
    pytest.param("dhlp2", "sparse", False, id="dhlp2-sparse-legacy"),
    pytest.param("dhlp1", "sparse", False, id="dhlp1-legacy"),
])
def test_solve_and_ranking_record_their_ranges(alg, backend, fused, net):
    eng = _engine(alg, backend, fused)
    eng.prepare(net)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, tops = _solve_and_rank(eng, net)
    got = _ranges(prof)
    assert set(got) == set(SOLVE_SPANS)
    assert not any(ua for ivs in got.values() for _, _, ua in ivs)
    assert len(got["lp.round"]) == res.outer_iters >= 2
    assert len(got["lp.topk"]) == len(tops) == net.R[PAIR].shape[0]
    for name in ("lp.seeds", "lp.upload", "lp.download", "lp.extract"):
        assert len(got[name]) == 1, name
    halts = len(got["lp.halt"])
    if alg == "dhlp2":  # one check a round, and the one that ends the loop
        assert res.converged and halts == res.outer_iters + 1
    else:  # and one before every inner round, and at most one ending each
        n, inner = res.outer_iters, res.inner_iters
        assert n + inner < halts <= 2 * n + 1 + inner
    # the host's order: Y built, uploaded, the rounds, F back, the ranking
    first = {k: min(s for s, _, _ in v) for k, v in got.items()}
    assert (first["lp.seeds"] < first["lp.upload"] < first["lp.round"] < first["lp.download"]
            < first["lp.extract"] < first["lp.topk"])


DENSE_SPANS = ("lp.seeds", "lp.upload", "lp.round", "lp.halt", "lp.download")


def _dense(alg, **kw):
    cfg = tc.LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed", max_inner=50, **kw)
    return te.make_engine("dense", cfg, device="cpu")


@pytest.mark.parametrize("alg, fused", [("dhlp2", True), ("dhlp2", False), ("dhlp1", True)],
                         ids=["dhlp2-fused", "dhlp2-split", "dhlp1"])
def test_dense_solve_records_its_ranges(alg, fused, net):
    eng = _dense(alg, fused=fused)
    eng.prepare(net)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.run(net)
    got = _ranges(prof)
    assert set(got) == set(DENSE_SPANS)
    assert not any(ua for ivs in got.values() for _, _, ua in ivs)
    assert len(got["lp.round"]) == res.outer_iters >= 2
    for name in ("lp.seeds", "lp.upload", "lp.download"):
        assert len(got[name]) == 1, name
    rounds = got["lp.round"]
    inside = sum(any(r0 <= s and e <= r1 for r0, r1, _ in rounds) for s, e, _ in got["lp.halt"])
    outside = len(got["lp.halt"]) - inside
    assert res.converged and outside == res.outer_iters + 1  # one a round, one to end
    if alg == "dhlp2":
        assert inside == 0
    else:  # every inner round's check, and at most one ending each inner loop
        assert res.inner_iters < inside <= res.inner_iters + res.outer_iters
    first = {k: min(s for s, _, _ in v) for k, v in got.items()}
    assert first["lp.seeds"] < first["lp.upload"] < first["lp.round"] < first["lp.download"]


def test_dense_spans_are_the_shared_no_op_when_nothing_records(net, monkeypatch):
    from repro_torch.core import solver

    made = []

    def recording(name):
        span = tprof.hot_span(name)
        made.append((name, span))
        return span

    monkeypatch.setattr(solver, "hot_span", recording)
    res = _dense("dhlp1").run(net)
    assert {name for name, _ in made} == set(DENSE_SPANS) - {"lp.seeds"}
    assert sum(name == "lp.round" for name, _ in made) == res.outer_iters
    assert all(span is _NULL_SPAN for _, span in made)


def test_bio_plan_records_its_three_parts_inside_it():
    # the parts of the plan built where the edges are: compaction, sort,
    # degrees, widths and the one small copy to the host; the block order,
    # the slot scatter, the rows and inv_perm; the per-bucket views
    src, dst, w, Y = _bio_inputs()
    cfg = dhlp_bio.REDUCED
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = dhlp_bio.lp_plan(src, dst, w, Y.shape[0])
        F = dhlp_bio.lp_rounds(plan, Y, Y.clone(), cfg)
    torch.testing.assert_close(F, dhlp_bio.lp_step_plain(cfg, src, dst, w, Y, Y.clone()),
                               rtol=1e-5, atol=1e-6)
    got = _ranges(prof)
    assert set(got) == {"bio.plan", *PLAN_PARTS}
    assert all(len(v) == 1 for v in got.values())
    (p0, p1, ua), = got["bio.plan"]
    assert not ua
    parts = [got[name][0] for name in PLAN_PARTS]
    for (s, e, ua), (s_next, _, _) in zip(parts, parts[1:] + [(p1, p1, False)]):
        assert p0 <= s <= e <= s_next and not ua
    assert sum(e - s for s, e, _ in parts) <= p1 - p0


@pytest.mark.parametrize("level, recorded", [("trace", True), ("metrics", False)])
def test_spans_land_in_an_installed_telemetry_with_parents(level, recorded, net):
    tel = to.Telemetry(level, run_id="spans")
    eng = _engine("dhlp2")
    src, dst, w, Y = _bio_inputs()
    tprof.install_kernel_hook(tel)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tel.span("phase", "solve") as phase:
                res, tops = _solve_and_rank(eng, net)
                # bio.plan and its three parts (download, bucket, upload), in order
                dhlp_bio.lp_plan(src, dst, w, Y.shape[0])
    finally:
        tprof.uninstall_kernel_hook()
    # the profiler's trace holds the ranges whatever the level
    assert set(_ranges(prof)) == {*SOLVE_SPANS, "bio.plan", *PLAN_PARTS}
    hot = [e for e in tel.events() if e.get("span") == "hot"]
    if not recorded:
        assert hot == []
        return
    for e in hot:
        assert validate_line(e) == "span"
    by_name = {}
    for e in hot:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == {*SOLVE_SPANS, "bio.plan", *PLAN_PARTS}
    assert len(by_name["lp.round"]) == res.outer_iters
    assert len(by_name["lp.topk"]) == len(tops)
    for name in (*SOLVE_SPANS, "bio.plan"):
        assert all(e["parent"] == phase.id for e in by_name[name]), name
    (plan,) = by_name["bio.plan"]
    for name in PLAN_PARTS:
        (part,) = by_name[name]
        assert part["parent"] == plan["id"]
        assert plan["t0"] <= part["t0"] and part["dur_s"] <= plan["dur_s"]


def test_topk_counts_the_path_it_takes_under_a_collector():
    rng = np.random.default_rng(5)
    row = rng.random(892)
    known = rng.random(892) < 0.05
    nan_row = row.copy()
    known[7] = False
    nan_row[7] = np.nan  # kept, so among the best: a partition ranks NaN highest
    tel = to.Telemetry("metrics", run_id="topk")
    tc.topk_exclusive(row, 20, known)  # no collector: nothing recorded
    assert tel.metrics.to_lines() == []

    def counts():
        return {p: getattr(tel.metrics.peek(f"rank.topk.{p}"), "value", 0)
                for p in ("select", "full_sort")}

    tprof.install_kernel_hook(tel)
    try:
        tc.topk_exclusive(row, 20, known)
        assert counts() == {"select": 1, "full_sort": 0}
        tc.topk_exclusive(nan_row, 20, known)
        assert counts() == {"select": 1, "full_sort": 1}
    finally:
        tprof.uninstall_kernel_hook()
    tc.topk_exclusive(nan_row, 20, known)
    assert counts() == {"select": 1, "full_sort": 1}


def test_lp_plan_counts_its_build_and_slots_under_a_collector():
    src, dst, w, Y = _bio_inputs()
    tel = to.Telemetry("metrics", run_id="plan")
    dhlp_bio.lp_plan(src, dst, w, Y.shape[0])  # no collector: nothing recorded
    assert tel.metrics.to_lines() == []

    def counts():
        return {p: getattr(tel.metrics.peek(f"bio.plan.{p}"), "value", 0)
                for p in ("builds", "slots")}

    tprof.install_kernel_hook(tel)
    try:
        plan = dhlp_bio.lp_plan(src, dst, w, Y.shape[0])
    finally:
        tprof.uninstall_kernel_hook()
    slots = sum(nbr.numel() for _, nbr, _, _ in plan.buckets)
    assert slots > int(torch.count_nonzero(w))  # padded slots, not the live ones
    assert counts() == {"builds": 1, "slots": slots}
    dhlp_bio.lp_plan(src, dst, w, Y.shape[0])
    assert counts() == {"builds": 1, "slots": slots}
