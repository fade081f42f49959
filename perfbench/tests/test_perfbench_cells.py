"""Each cell at a tiny size, against the plain reference; its control; its faults.

A run is driven through ``runner.run`` as ``perfbench/run.py`` drives it,
on the CPU (the program's kernels then take their plain versions).  The
check that no JAX module is loaded is tested in a subprocess
(``test_perfbench_harness.py``): these tests share a process with test
files that import JAX, so here it is switched off.
"""

import math

import numpy as np
import pytest
import torch

from _tiny import CELLS, tiny_cell

from perfbench.harness import runner

SEED = 2**31 + 17  # seeds may exceed what 32 signed bits hold


@pytest.fixture(autouse=True)
def _no_module_check(monkeypatch):
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _run(name, *, traced=False, control=False, device="cpu", seconds=0.3, seed=SEED):
    return runner.run(tiny_cell(name), seed=seed, seconds=seconds, traced=traced,
                      device=device, t0=0.0, control=control)


def _schema(out, cell_name, traced):
    cell = tiny_cell(cell_name)
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and out["failed"] >= 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert dev["window_s"] > 0 and dev["busy_s"] >= 0
        for key in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][key]) <= 10
        allowed = {m["name"] for m in cell.per_layer}
        assert set(out["metrics"]) <= allowed
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for name, c in out["check"].items():
        assert set(c) == {"value", "limit"} and name in cell.limits


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_against_the_reference(name, device):
    out = _run(name, device=device)
    _schema(out, name, traced=False)
    assert out["correct"], out["check"]
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(name):
    out = _run(name, traced=True)
    _schema(out, name, traced=True)
    assert out["correct"], out["check"]
    if name == "pl1m-dhlp2-solve":
        assert out["metrics"]["solve.rounds"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, device):
    """The control: the program with its own bfloat16 path switched on."""
    out = _run(name, control=True, device=device)
    assert not out["correct"], out["check"]


def _patch_round(monkeypatch, fault):
    """Break the fused plan round the solve engines run."""
    from repro_torch.engine import sparse

    real = sparse._plan_round

    def broken(buckets, F, base, **kw):
        Fn, delta = real(buckets, F, base, **kw)
        if fault == "unchanged":
            return F.clone().float(), torch.zeros_like(delta)
        half = F.shape[1] // 2
        Fn[:, half:] = F[:, half:].float()
        delta[half:] = 0.0
        return Fn, delta

    monkeypatch.setattr(sparse, "_plan_round", broken)


def _patch_bio(monkeypatch, fault):
    from repro_torch.configs import dhlp_bio

    real = dhlp_bio.lp_step_plain

    def broken(cfg, src, dst, w, Y, F):
        out = real(cfg, src, dst, w, Y, F)
        if fault == "unchanged":
            return F
        if fault == "half":
            out[:, out.shape[1] // 2 :] = F[:, out.shape[1] // 2 :]
            return out
        out[0, 0] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(dhlp_bio, "lp_step_plain", broken)


def _patch_answer(monkeypatch):
    """An answer altered where it is produced: the ranking drops its best."""
    from repro_torch.core import ranking

    real = ranking.topk_exclusive

    def broken(scores, top_k, exclude=None):
        return real(scores, top_k + 1, exclude)[1:]

    monkeypatch.setattr(ranking, "topk_exclusive", broken)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """A step that returns its state unchanged; half of the batch left out;
    an answer altered where it is produced.  (One card: no exchange.)"""
    if name == "bio20m-step":
        _patch_bio(monkeypatch, fault)
    elif fault == "answer":
        _patch_answer(monkeypatch)
    else:
        _patch_round(monkeypatch, fault)
    out = _run(name)
    assert not out["correct"], out["check"]


def test_seeds_make_the_same_work_in_another_order():
    """Two seeds: the same sizes and nonzeros, other labels."""
    from perfbench.harness import drugnet

    cell = tiny_cell("pl1m-dhlp2-solve")
    a, b = drugnet.make(cell.config, 1), drugnet.make(cell.config, 2)
    assert a.sizes == b.sizes and a.operator_nnz() == b.operator_nnz()
    assert not np.array_equal(a.R[(0, 2)], b.R[(0, 2)])
