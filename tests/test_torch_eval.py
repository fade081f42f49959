"""Port evaluation layer vs the JAX reference: metrics, CV, drugnet, recovery.

Inputs are made once with numpy (or by the bit-identical scenario
generators) and handed to both packages.  Host-side pieces (metrics, fold
masks, generated and masked networks, recovery problems) must be
identical; solves are held to the reference's tolerances.  The last group
is the scenario-matrix exit gate of ROADMAP A.4: the fast rows of
``repro.bench.matrix._scenario_rows`` give the same ``recovery_auc`` and
``outer_iters`` on every backend, and ``agree_ref`` holds at 5e-3.
"""

import numpy as np
import pytest
import torch

import repro.eval as re_eval
import repro.scenarios as rs
import repro_torch.eval as te_eval
import repro_torch.scenarios as ts
from repro.core.solver import LPConfig as JaxLPConfig
from repro.data.drugnet import DrugNetSpec as JaxDrugNetSpec
from repro.data.drugnet import make_drugnet as jax_make_drugnet
from repro_torch.core import from_numpy
from repro_torch.core.solver import LPConfig
from repro_torch.data import DrugNetSpec, make_drugnet

AGREE_TOL = 5e-3  # agree_ref (DESIGN.md §15.3)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _same_net(got, want):
    assert got.sizes == want.sizes and got.type_names == want.type_names
    for p, q in zip(got.P, want.P):
        _same(p, q)
    assert sorted(got.R) == sorted(want.R)
    for k in want.R:
        _same(got.R[k], want.R[k])


# ------------------------------------------------------------------ metrics


def _scores_and_labels(seed, n=400, ties=True):
    rng = np.random.default_rng(seed)
    scores = rng.random(n)
    if ties:  # heavy ties exercise the average-rank path
        scores = np.round(scores * 20) / 20
    labels = rng.random(n) < 0.3
    return scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ties", [True, False])
def test_metrics_identical(seed, ties):
    scores, labels = _scores_and_labels(seed, ties=ties)
    for name in ("auc_score", "aupr_score", "best_accuracy"):
        assert getattr(te_eval, name)(scores, labels) == getattr(re_eval, name)(
            scores, labels
        )
    assert te_eval.evaluate_predictions(scores, labels) == re_eval.evaluate_predictions(
        scores, labels
    )


def test_metrics_reject_one_class():
    for bad in (np.ones(5, bool), np.zeros(5, bool)):
        with pytest.raises(ValueError, match="one positive and one negative"):
            te_eval.auc_score(np.arange(5.0), bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        te_eval.aupr_score(np.arange(5.0), np.ones(4, bool))


# ------------------------------------------------------- network and folds


@pytest.fixture(scope="module")
def small_spec():
    return dict(n_drug=48, n_disease=32, n_target=24, n_clusters=6, seed=3)


def test_make_drugnet_bit_identical(small_spec):
    for kw in ({}, small_spec):
        got, want = make_drugnet(DrugNetSpec(**kw)), jax_make_drugnet(
            JaxDrugNetSpec(**kw)
        )
        _same_net(got.network, want.network)
        for a, b in zip(got.clusters, want.clusters):
            _same(a, b)
        assert sorted(got.truth) == sorted(want.truth)
        for k in want.truth:
            _same(got.truth[k], want.truth[k])
        assert got.pair_names == want.pair_names


def test_type_of_node_and_masked_fold_identical(small_spec):
    want_net = jax_make_drugnet(JaxDrugNetSpec(**small_spec)).network
    got_net = make_drugnet(DrugNetSpec(**small_spec)).network
    _same(got_net.type_of_node(), want_net.type_of_node())
    mask = np.random.default_rng(0).random(want_net.R[(0, 2)].shape) < 0.2
    for pair in ((0, 2), (2, 0)):
        _same_net(got_net.with_masked_fold(pair, mask), want_net.with_masked_fold(pair, mask))
    # the source network is untouched
    _same_net(got_net, want_net)


@pytest.mark.parametrize("k,seed", [(10, 0), (5, 7), (3, 1)])
def test_kfold_masks_identical(small_spec, k, seed):
    dn = jax_make_drugnet(JaxDrugNetSpec(**small_spec))
    R = dn.network.R[(0, 2)]
    for positives in (None, dn.truth[(0, 2)] & (R > 0)):
        got = list(te_eval.kfold_masks(R, k=k, seed=seed, positives=positives))
        want = list(re_eval.kfold_masks(R, k=k, seed=seed, positives=positives))
        assert len(got) == len(want) == k
        for a, b in zip(got, want):
            _same(a, b)
    with pytest.raises(ValueError, match="present edges"):
        next(te_eval.kfold_masks(R, positives=np.ones_like(R, dtype=bool)))


def test_cross_validate_identical(small_spec):
    """The protocol with one deterministic numpy scorer in both packages."""
    want_net = jax_make_drugnet(JaxDrugNetSpec(**small_spec)).network
    got_net = make_drugnet(DrugNetSpec(**small_spec)).network

    def scorer(masked):  # a neighbourhood score: P_drug · R · P_target
        return masked.P[0] @ masked.R[(0, 2)] @ masked.P[2]

    got = te_eval.cross_validate(got_net, (2, 0), scorer, k=4, seed=5)
    want = re_eval.cross_validate(want_net, (2, 0), scorer, k=4, seed=5)
    assert [(r.fold, r.metrics) for r in got] == [(r.fold, r.metrics) for r in want]
    assert te_eval.summarize(got) == re_eval.summarize(want)
    with pytest.raises(ValueError, match="expected"):
        te_eval.cross_validate(got_net, (0, 2), lambda m: np.zeros((2, 2)), k=2)


# ------------------------------------------------------------ recovery


def _bundles(name, scale):
    want = rs.generate(name, scale=scale, seed=0, cache=False)
    got = ts.generate(name, scale=scale, seed=0, cache=False)
    return got, want


@pytest.mark.parametrize(
    "name,scale,kw",
    [
        ("bio_tri", 0.25, dict()),
        ("kpartite5", 0.35, dict(holdout_frac=0.2, max_entities=8, seed=4)),
        ("powerlaw", 0.02, dict(max_entities=16)),
    ],
)
def test_make_recovery_problem_identical(name, scale, kw):
    got_b, want_b = _bundles(name, scale)
    got = ts.make_recovery_problem(got_b, **kw)
    want = rs.make_recovery_problem(want_b, **kw)
    assert got.pair == want.pair and got.target_slice == want.target_slice
    _same_net(got.masked_net, want.masked_net)
    for attr in ("Y", "rows", "heldout", "negatives"):
        _same(getattr(got, attr), getattr(want, attr))
    assert got.num_heldout == want.num_heldout
    F = np.random.default_rng(1).random((got.masked_net.num_nodes, got.Y.shape[1]))
    assert got.metrics(F) == want.metrics(F)


def test_recovery_runs_on_the_card_unless_asked(monkeypatch):
    got_b, _ = _bundles("bipartite", 0.35)
    problem = ts.make_recovery_problem(got_b, max_entities=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.solve_recovery(problem, "sparse")
    res = ts.solve_recovery(problem, "sparse", device="cpu")
    assert res.F.shape == problem.Y.shape and res.converged


#: the fast rows of ``repro.bench.matrix._scenario_rows`` (backends[0] is
#: the agreement reference); the matrix uses max_entities=16 in its fast pass
MATRIX_FAST_ROWS = (
    ("bipartite", 0.35, ("dense", "sparse")),
    ("kpartite5", 0.35, ("dense", "sparse")),
    ("kpartite_heterophilic", 0.35, ("dense", "sparse")),
    ("powerlaw", 0.02, ("dense", "sparse")),
)


def test_matrix_rows_are_the_references():
    from repro.bench.matrix import _scenario_rows

    assert _scenario_rows(True) == MATRIX_FAST_ROWS


@pytest.mark.parametrize("name,scale,backends", MATRIX_FAST_ROWS, ids=lambda v: str(v))
def test_scenario_matrix_exit_gate(name, scale, backends):
    """``recovery_auc``, ``outer_iters`` and ``agree_ref`` per backend, as
    the ``scenario_matrix`` suite computes them (fixed seeds, σ = 1e-4)."""
    from repro.engine import make_engine as jax_make_engine
    from repro_torch.engine import make_engine

    got_b, want_b = _bundles(name, scale)
    kw = dict(holdout_frac=0.1, max_entities=16, seed=0)
    got_p = ts.make_recovery_problem(got_b, **kw)
    want_p = rs.make_recovery_problem(want_b, **kw)
    cfg = dict(sigma=1e-4, seed_mode="fixed", autotune=False)
    F_ref = W_ref = None
    for backend in backends:
        want = jax_make_engine(backend, JaxLPConfig(backend=backend, **cfg)).run(
            want_p.masked_net, seeds=want_p.Y
        )
        got = make_engine(backend, LPConfig(backend=backend, **cfg), device="cpu").run(
            got_p.masked_net, seeds=got_p.Y
        )
        assert got.outer_iters == want.outer_iters
        assert got_p.metrics(got.F)["recovery_auc"] == want_p.metrics(want.F)["recovery_auc"]
        if F_ref is None:
            F_ref, W_ref = got.F, want.F
        else:
            assert float(np.max(np.abs(got.F - F_ref))) <= AGREE_TOL
            assert float(np.max(np.abs(want.F - W_ref))) <= AGREE_TOL


@pytest.mark.parametrize("alg", ["dhlp2", "dhlp1"])
def test_recovery_auc_matches_reference(alg):
    got_b, want_b = _bundles("kpartite_heterophilic", 0.35)
    cfg = dict(alg=alg, sigma=1e-4, seed_mode="fixed", autotune=False)
    got = ts.recovery_auc(got_b, "sparse", lp=LPConfig(**cfg), device="cpu", max_entities=8)
    want = rs.recovery_auc(want_b, "sparse", lp=JaxLPConfig(**cfg), max_entities=8)
    assert got == want


def test_scenario_cross_validate_matches_reference():
    got_b, want_b = _bundles("bipartite", 0.35)
    kw = dict(backend="dense", k=3, seed=2)
    got = ts.scenario_cross_validate(got_b, device="cpu", **kw)
    want = rs.scenario_cross_validate(want_b, **kw)
    assert [r.fold for r in got] == [r.fold for r in want]
    for g, w in zip(got, want):
        assert g.metrics.keys() == w.metrics.keys()
        for key in w.metrics:
            assert g.metrics[key] == w.metrics[key]


def test_default_lp_config_matches_reference():
    got, want = ts.default_lp_config(), rs.default_lp_config()
    for field in ("alg", "alpha", "sigma", "seed_mode", "max_iter"):
        assert getattr(got, field) == getattr(want, field)
    assert ts.default_lp_config(1e-6).sigma == 1e-6


def test_from_numpy_keeps_the_eval_methods(small_spec):
    net = jax_make_drugnet(JaxDrugNetSpec(**small_spec)).network
    port = from_numpy(net.P, net.R, net.type_names)
    _same(port.type_of_node(), net.type_of_node())
