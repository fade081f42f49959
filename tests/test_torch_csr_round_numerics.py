"""B3's row sum on long rows, emulated on the CPU.

The ``dhlp-bio`` step gives ``csr_round`` (B3) rows of 110,134 live slots
at ``scale_1m`` (node 0 of ``powerlaw_graph``) and about 2 M at
``scale_20m``.  One lane summing such a row as one running f32 sum, an
FMA a slot, drifts from the exact sum with the row's length; B3 sums each
32-slot chunk into a fresh partial and adds the partials with Kahan
compensation (``csrc/csr_round_common.cuh``, ``kCompensated``).  Both
schedules are emulated here in numpy (an FMA is the f64 product, exact
for f32 operands, added in f64 and rounded once to f32) on that hub row
and held to an f64 sum.  The kernels themselves run on the card
(``chip_smoke.py`` phase 15, ``tests/test_torch_zoo_gpu.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import dhlp_bio
from repro_torch.graph.segment import gcn_norm
from repro_torch.graph.structures import powerlaw_graph

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol
CHUNK = 32  # slots a warp loads at a time: one partial each


def _fma(acc, w, x):
    return (acc.astype(np.float64) + np.float64(w) * x.astype(np.float64)).astype(np.float32)


def _running(w, X):
    """One running f32 sum, an FMA a slot (B1's schedule)."""
    acc = np.zeros(X.shape[1], np.float32)
    for k in range(len(w)):
        acc = _fma(acc, w[k], X[k])
    return acc


def _compensated(w, X):
    """32-slot partials added with Kahan compensation (B3's schedule)."""
    acc = np.zeros(X.shape[1], np.float32)
    comp = np.zeros(X.shape[1], np.float32)
    for k0 in range(0, len(w), CHUNK):
        part = np.zeros(X.shape[1], np.float32)
        for k in range(k0, min(k0 + CHUNK, len(w))):
            part = _fma(part, w[k], X[k])
        y = part - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


@pytest.fixture(scope="module")
def hub_row():
    """scale_1m's longest row (node 0, 110,134 live slots) and 16 columns
    of F drawn uniformly in [0, 1), as phase 15's bucket gate draws them."""
    sh = dhlp_bio.LP_SHAPES["scale_1m"]
    n, e = sh["num_nodes"], sh["num_edges"]
    g = powerlaw_graph(n, e, seed=0, device="cpu")
    src, dst = torch.from_numpy(g.src), torch.from_numpy(g.dst)
    w = 0.5 * gcn_norm(src, dst, torch.ones(e), n)
    plan = dhlp_bio.lp_plan(src, dst, w, n)
    _, nbr, wgt, live = max(plan.buckets, key=lambda b: b[1].shape[1])
    r = int(torch.argmax(live.lengths))
    length = int(live.lengths[r])
    F = torch.rand((n, 16), generator=torch.Generator().manual_seed(15))
    X = F[nbr[r, :length].long()].numpy()
    return wgt[r, :length].numpy(), X


def test_the_hub_row_is_the_long_row(hub_row):
    w, X = hub_row
    assert len(w) == 110_134 and (w > 0).all()


def test_compensated_sum_holds_an_f64_sum_where_a_running_sum_drifts(hub_row):
    w, X = hub_row
    exact = (w.astype(np.float64)[:, None] * X.astype(np.float64)).sum(axis=0)
    run_err = np.abs(_running(w, X) - exact).max() / np.abs(exact).max()
    comp = _compensated(w, X)
    comp_err = np.abs(comp - exact).max() / np.abs(exact).max()
    assert run_err > 5e-5  # the running sum drifts with the row's length
    assert comp_err < 2e-6 and comp_err * 30 < run_err
    np.testing.assert_allclose(comp, exact, **F32_TOL)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 1000])
def test_compensated_sum_of_a_short_row_is_the_slot_order_sum(length):
    rng = np.random.default_rng(length)
    w = rng.random(length).astype(np.float32)
    X = rng.random((length, 8)).astype(np.float32)
    np.testing.assert_allclose(_compensated(w, X), _running(w, X), rtol=1e-6, atol=1e-7)


def test_only_the_round_kernel_compensates():
    """B3 instantiates the compensated sum; B1's launch keeps the running sum."""
    b3 = (CSRC / "csr_round.cu").read_text()
    b1 = (CSRC / "csr_round_residual.cu").read_text()
    common = (CSRC / "csr_round_common.cuh").read_text()
    assert "launch<T, T, false, kMaxWarps, true>" in b3
    assert "launch<T, float, true, kMaxWarps>" in b1
    assert "bool kCompensated = false" in common
