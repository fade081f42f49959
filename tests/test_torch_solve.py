"""Port solves vs the JAX reference on the ``bio_tri`` scenario (118 nodes).

The port's ``kernel`` and ``sparse`` engines (on the CPU, where the kernel
engine runs its plain version) are held against ``repro``'s ``kernel``
engine (Pallas in interpret mode) and ``sparse`` engine; the port's dense
``HeteroLP`` — plain and with ``use_kernel=True`` — against ``repro``'s.
Checks: F within the kernel tolerances (f32 ``rtol=2e-4, atol=5e-4``,
bf16 ``2e-2``), equal ``outer_iters`` and ``per_column_iters``, and
identical drug→target top-10 lists.
"""

import warnings

import numpy as np
import pytest

import repro.core as rc
import repro.engine as re_
import repro.scenarios as rs
import repro_torch.core as tc
import repro_torch.engine as te

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def nets():
    net = rs.generate("bio_tri", scale=0.25, seed=0, cache=False).network
    return net, tc.from_numpy(net.P, net.R, net.type_names)


def _top10(F, net):
    scores = tc.extract_outputs(F, net.normalize()).interactions[(0, 2)]
    known = net.R[(0, 2)] > 0
    return [
        tuple(tc.topk_exclusive(scores[d], 10, known[d])) for d in range(known.shape[0])
    ]


def _agree(got, want, net, tol):
    np.testing.assert_allclose(got.F, want.F, **tol)
    assert got.outer_iters == want.outer_iters
    assert got.inner_iters == want.inner_iters
    np.testing.assert_array_equal(got.per_column_iters, want.per_column_iters)
    assert got.converged == want.converged
    if got.F.shape[0] == got.F.shape[1]:
        assert _top10(got.F, net) == _top10(want.F, net)


def _warm_start(net):
    """A shared F0: a coarse solve, so warm and cold runs differ."""
    cfg = rc.LPConfig(alg="dhlp2", sigma=1e-2, seed_mode="fixed")
    return rc.HeteroLP(cfg).run(net).F


ENGINE_CASES = {
    "fixed": dict(seed_mode="fixed"),
    "drift": dict(seed_mode="drift"),
    "momentum": dict(seed_mode="fixed", momentum=0.3),
    "seed_chunk": dict(seed_mode="fixed", seed_chunk=40),
    "bf16": dict(seed_mode="fixed", storage_dtype="bf16"),
    "warm_start": dict(seed_mode="fixed"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_csr_engines_match_reference(nets, backend, case):
    net, pnet = nets
    kw = dict(alg="dhlp2", sigma=1e-4, autotune=False, **ENGINE_CASES[case])
    F0 = _warm_start(net) if case == "warm_start" else None
    want = re_.make_engine(backend, rc.LPConfig(**kw)).run(net, F0=F0)
    got = te.make_engine(backend, tc.LPConfig(**kw), device="cpu").run(pnet, F0=F0)
    _agree(got, want, net, BF16_TOL if case == "bf16" else F32_TOL)
    if case == "warm_start":
        cold = te.make_engine(backend, tc.LPConfig(**kw), device="cpu").run(pnet)
        assert got.outer_iters < cold.outer_iters


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_csr_round_with_residual_matches_reference(nets, backend):
    net, pnet = nets
    kw = dict(alg="dhlp2", seed_mode="fixed", autotune=False)
    Y = rc.seeds_for_nodes(net.num_nodes, [0, 3, 60, 100, 117])
    F = Y + np.random.default_rng(1).random(Y.shape) * 0.1
    w_eng = re_.make_engine(backend, rc.LPConfig(**kw))
    g_eng = te.make_engine(backend, tc.LPConfig(**kw), device="cpu")
    w_out, w_delta = w_eng.round_with_residual(w_eng.prepare(net), F, Y)
    g_out, g_delta = g_eng.round_with_residual(g_eng.prepare(pnet), F, Y)
    np.testing.assert_allclose(g_out, w_out, **F32_TOL)
    np.testing.assert_allclose(g_delta, w_delta, **F32_TOL)
    np.testing.assert_allclose(
        g_eng.round(g_eng.prepare(pnet), F, Y), w_out, **F32_TOL
    )


DENSE_CASES = {
    "fixed": dict(seed_mode="fixed"),
    "drift": dict(seed_mode="drift"),
    "momentum": dict(seed_mode="fixed", momentum=0.3),
    "seed_chunk": dict(seed_mode="fixed", seed_chunk=50),
    "use_kernel": dict(seed_mode="fixed", use_kernel=True),
    "use_kernel_drift": dict(seed_mode="drift", use_kernel=True),
    "unfused": dict(seed_mode="fixed", fused=False),
    "dhlp1": dict(alg="dhlp1"),
    "warm_start": dict(seed_mode="fixed"),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_heterolp_matches_reference(nets, case):
    net, pnet = nets
    kw = dict(alg="dhlp2", sigma=1e-4, backend="dense")
    kw.update(DENSE_CASES[case])
    F0 = _warm_start(net) if case == "warm_start" else None
    want = rc.HeteroLP(rc.LPConfig(**kw)).run(net, F0=F0)
    got = tc.HeteroLP(tc.LPConfig(**kw), device="cpu").run(pnet, F0=F0)
    _agree(got, want, net, F32_TOL)


def test_dense_sequential_matches_reference(nets):
    net, pnet = nets
    kw = dict(alg="dhlp2", sigma=1e-4, seed_mode="fixed", mode="sequential")
    Y = rc.seeds_for_nodes(net.num_nodes, [2, 40, 99])
    want = rc.HeteroLP(rc.LPConfig(**kw)).run(net, seeds=Y)
    got = tc.HeteroLP(tc.LPConfig(**kw), device="cpu").run(pnet, seeds=Y)
    _agree(got, want, net, F32_TOL)


def test_dense_engine_round_matches_reference(nets):
    net, pnet = nets
    kw = dict(alg="dhlp2", seed_mode="fixed")
    Y = rc.seeds_for_nodes(net.num_nodes, [1, 7, 50])
    F = Y * 0.5 + 0.01
    w_eng = re_.make_engine("dense", rc.LPConfig(**kw))
    g_eng = te.make_engine("dense", tc.LPConfig(**kw), device="cpu")
    np.testing.assert_allclose(
        g_eng.round(g_eng.prepare(pnet), F, Y),
        w_eng.round(w_eng.prepare(net), F, Y),
        **F32_TOL,
    )
    g_out, g_delta = g_eng.round_with_residual(g_eng.prepare(pnet), F, Y)
    w_out, w_delta = w_eng.round_with_residual(w_eng.prepare(net), F, Y)
    np.testing.assert_allclose(g_delta, w_delta, **F32_TOL)


def test_use_kernel_deprecation_shim_matches_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = rc.LPConfig(use_kernel=True)
    with pytest.warns(DeprecationWarning, match="backend='kernel'"):
        got = tc.LPConfig(use_kernel=True)
    assert got.backend == want.backend == "kernel"
    explicit = tc.LPConfig(backend="dense", use_kernel=True)
    assert explicit.backend == "dense" and explicit.use_kernel


def test_registry_and_auto_policy_match_reference():
    assert te.AUTO_DENSE_MAX_NODES == re_.AUTO_DENSE_MAX_NODES
    for n in (10, 4096, 4097, 4396):
        assert te.select_backend(n) == re_.select_backend(n)
        assert te.resolve_backend("auto", num_nodes=n) == re_.resolve_backend(
            "auto", num_nodes=n
        )
    assert set(te.available_backends()) == {"dense", "sparse", "kernel"}
    with pytest.raises(te.UnknownBackendError):
        te.resolve_backend("sharded")


def test_unported_paths_raise_and_name_the_roadmap(nets):
    _, pnet = nets
    with pytest.raises(te.BackendUnsupported, match="ROADMAP queue A.4"):
        te.make_engine("sparse", tc.LPConfig(alg="dhlp1"), device="cpu").prepare(pnet)
    with pytest.raises(te.BackendUnsupported, match="ROADMAP queue A.4"):
        te.make_engine(
            "sparse", tc.LPConfig(), device="cpu", fused_superstep=False
        )
    with pytest.raises(te.BackendUnsupported, match="dhlp1"):
        te.make_engine("kernel", tc.LPConfig(alg="dhlp1"), device="cpu").prepare(pnet)
