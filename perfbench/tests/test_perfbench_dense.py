"""The dense-similarity cell (``ds20m-dhlp2-dense``) at a tiny size, on the CPU.

Its network is the 20,000-edge shrink of ``drugnet-densesim-20m``: the
same type ratio and degree law, and every similarity score kept, so the
three intra-type blocks are dense.  Its solve runs on the program's
``dense`` engine (``core/solver.py``), against the plain reference; its
control is that engine's bfloat16 storage.  The cell reports the solve
metrics of ``pl1m-dhlp2-solve`` through the same readers: the dense
engine opens the sparse engine's ranges and fills the same counters.  The
CPU has no device kernels, so ``round.roofline.solve`` is read there on a
synthetic device trace; on a card, on the run's own.
"""

import json
import math

import numpy as np
import pytest
import torch

from _tiny import ROOT, tiny_cell

from perfbench.harness import drugnet, roofline, runner, spec, trace

NAME = "ds20m-dhlp2-dense"
SEED = 2**31 + 17
SPAN_METRICS = ("rank.extract_ms", "rank.topk_ms", "solve.seed_ms", "solve.halt_wait_ms",
                "solve.download_ms")
DEVICE_METRICS = ("round.roofline.solve", "device.idle.solve", "device.idle.named.solve")
METRICS = ("solve.rounds", "round.roofline.solve", "device.idle.solve") + SPAN_METRICS + (
    "device.idle.named.solve",)
MS = 1_000_000


@pytest.fixture(autouse=True)
def _no_module_check(monkeypatch):
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _run(*, traced=False, control=False, device="cpu", seconds=0.3):
    return runner.run(tiny_cell(NAME), seed=SEED, seconds=seconds, traced=traced, device=device,
                      t0=0.0, control=control)


def test_the_cell_loads_through_its_files():
    cell = spec.load_cell(ROOT, NAME)
    assert cell.chips == 1 and cell.traffic["engine"] == "dense"
    assert cell.traffic["alg"] == "dhlp2" and cell.traffic["kind"] == "solve"
    assert set(cell.limits) == {"f_err", "rank_gap", "halt_err"}
    assert [m["name"] for m in cell.end_to_end] == ["solve_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    # the same readers as the sparse-engine DHLP-2 cell's solve metrics
    other = spec.load_cell(ROOT, "pl1m-dhlp2-solve")
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in other.per_layer}
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    readings = json.loads((ROOT / "perfbench" / "cells" / f"{NAME}.json").read_text())["readings"]
    for name, lim in cell.limits.items():  # each limit between its two readings
        assert readings[name]["program_max"] <= lim < readings[name]["control_min"], name
    # the generator of drugnet-powerlaw-1m, but for the scale and the dense blocks
    g = cell.config["generator"]
    base = spec.load_cell(ROOT, "pl1m-dhlp2-solve").config["generator"]
    assert {k for k in g if g[k] != base[k]} == {"target_edges", "dense_sim_noise"}
    assert g["target_edges"] == 20_000_000 and g["dense_sim_noise"] is True
    assert cell.config["reduced"] == []


def test_every_similarity_block_is_dense():
    net = drugnet.make(tiny_cell(NAME).config, 1)
    assert all(np.count_nonzero(p) == p.size for p in net.P)
    assert net.operator_nnz() > 0.3 * net.num_nodes**2


def test_the_cell_is_correct_against_the_reference(device):
    out = _run(device=device)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["metrics"]["solve_s"]["value"] > 0
    assert set(out["check"]) == {"f_err", "rank_gap", "halt_err"}


def test_the_control_is_not_correct(device):
    """The dense engine's bfloat16 storage, the program's own control."""
    out = _run(control=True, device=device)
    assert not out["correct"], out["check"]
    assert out["check"]["f_err"]["value"] > out["check"]["f_err"]["limit"]


def _patch_dense(monkeypatch, fault):
    """Break the dense engine's fused loop, or the ranking after it."""
    from repro_torch.core import ranking, solver

    if fault == "answer":
        real_topk = ranking.topk_exclusive
        monkeypatch.setattr(ranking, "topk_exclusive",
                            lambda scores, k, exclude=None: real_topk(scores, k + 1, exclude)[1:])
        return
    real = solver._dhlp2_fused_loop

    def broken(A_eff, beta2, Y, F0, **kw):
        F, it, cols = real(A_eff, beta2, Y, F0, **kw)
        if fault == "unchanged":
            return F0.clone(), it, cols
        F = F.clone()
        half = F.shape[1] // 2
        F[:, half:] = F0[:, half:]
        return F, it, cols

    monkeypatch.setattr(solver, "_dhlp2_fused_loop", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_a_broken_dense_solve_is_not_correct(fault, monkeypatch):
    _patch_dense(monkeypatch, fault)
    out = _run()
    assert not out["correct"], out["check"]


def test_a_traced_run_reads_the_solve_metrics():
    out = _run(traced=True)
    assert out["correct"], out["check"]
    for name in SPAN_METRICS:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    assert out["metrics"]["solve.rounds"]["value"] >= 1
    # no device kernels on the CPU: those metrics are left out, not zero
    assert set(out["metrics"]) == set(METRICS) - set(DEVICE_METRICS)


def _one_solve_trace(kernel_ms, program=True):
    """One solve 0-50 ms in a 100 ms window, a kernel of ``kernel_ms`` in
    it; with ``program``, the dense engine's ranges."""
    prog = [("lp.seeds", 0, 1), ("lp.upload", 1, 4), ("lp.round", 5, 30), ("lp.halt", 8, 28), ("lp.halt", 30, 31),
            ("lp.download", 32, 40)] if program else []
    host = [("window", 0, 100), ("solve", 0, 50)] + prog
    return trace.Trace(
        dev_name=["sgemm"], dev_kind=np.asarray(["kernel"], dtype="U8"),
        dev_start=np.asarray([10 * MS]), dev_end=np.asarray([10 * MS + int(kernel_ms * MS)]),
        spans={"window": (np.asarray([0]), np.asarray([100 * MS])),
               "solve": (np.asarray([0]), np.asarray([50 * MS]))},
        host_name=[n for n, _, _ in host],
        host_start=np.asarray([s * MS for _, s, _ in host], dtype=np.int64),
        host_end=np.asarray([e * MS for _, _, e in host], dtype=np.int64),
        window=(0, 100 * MS))


def test_the_roofline_counts_each_round_over_its_active_columns():
    """Two rounds: three columns, then the two still active; against unit
    peaks, so the least time is the larger of operations and bytes."""
    n, nnz = 10, 40
    counters = {"solve.column_rounds": [np.asarray([2, 1, 2])], "solve.n": n, "solve.nnz": nnz,
                "solve.base_is_f": False}
    peaks = {"flops": 1.0, "bytes_per_s": 1.0}

    def least(s):  # the bytes bound these shapes
        flops = 2 * nnz * s + 4 * n * s
        nbytes = 8 * nnz + 4 * (n + 1) + 3 * 4 * n * s + 4 * s
        return max(flops, nbytes)

    want_s = least(3) + least(2)
    assert want_s == sum(roofline.least_seconds(
        roofline.lp_round(n=n, nnz=nnz, s=s, residual=True, base_is_f=False), peaks)["seconds"]
        for s in (3, 2))
    tr = _one_solve_trace(kernel_ms=4.0)
    read = spec.load_cell(ROOT, NAME).reader("round.roofline.solve")
    got = read(runner.Context(trace=tr, counters=counters, peaks=peaks))
    assert got == pytest.approx(100.0 * want_s / 4e-3, rel=1e-12)
    # no trace, no peaks (an unknown card), no device kernel: nothing to read
    assert read(runner.Context(trace=None, counters=counters, peaks=peaks)) is None
    assert read(runner.Context(trace=tr, counters=counters, peaks=None)) is None
    assert read(runner.Context(trace=_one_solve_trace(0.0), counters=counters,
                               peaks=peaks)) is None


@pytest.mark.parametrize("metric, want", [
    ("solve.seed_ms", 1.0 + 3.0), ("solve.halt_wait_ms", 20.0 + 1.0),
    ("solve.download_ms", 8.0),
])
def test_the_span_readers_on_a_synthetic_trace(metric, want):
    read = spec.load_cell(ROOT, NAME).reader(metric)
    ctx = runner.Context(trace=_one_solve_trace(4.0), counters={}, peaks=None)
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    # a program without the dense engine's ranges (an older one): left out
    bare = runner.Context(trace=_one_solve_trace(4.0, program=False), counters={}, peaks=None)
    assert read(bare) is None
    assert read(runner.Context(trace=None, counters={}, peaks=None)) is None


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(traced=True, device="cuda", seconds=1.0)
    assert out["correct"], out["check"]
    assert set(METRICS) <= set(out["metrics"])
    assert 0 < out["metrics"]["round.roofline.solve"]["value"] <= 100
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
