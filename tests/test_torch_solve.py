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
    """Every blocked-CSR path is ported; ``kernel`` stays DHLP-2 only and
    refuses DHLP-1 naming it, as the reference does."""
    net, pnet = nets
    with pytest.raises(re_.BackendUnsupported, match="dhlp1"):
        re_.make_engine("kernel", rc.LPConfig(alg="dhlp1")).prepare(net)
    with pytest.raises(te.BackendUnsupported, match="dhlp1"):
        te.make_engine("kernel", tc.LPConfig(alg="dhlp1"), device="cpu").prepare(pnet)


# ---------------------------------------------------------------------------
# Legacy node-order loops (fused_superstep=False) and DHLP-1 on blocked CSR
# ---------------------------------------------------------------------------

LEGACY_CASES = {
    "fixed": dict(seed_mode="fixed"),
    "drift": dict(seed_mode="drift"),
    "momentum": dict(seed_mode="fixed", momentum=0.3),
    "seed_chunk": dict(seed_mode="fixed", seed_chunk=40),
    # the legacy loop ignores storage_dtype in both packages: f32 throughout
    "bf16_ignored": dict(seed_mode="fixed", storage_dtype="bf16"),
    "warm_start": dict(seed_mode="fixed"),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_legacy_dhlp2_loop_matches_reference(nets, backend, case):
    net, pnet = nets
    kw = dict(alg="dhlp2", sigma=1e-4, autotune=False, **LEGACY_CASES[case])
    F0 = _warm_start(net) if case == "warm_start" else None
    want = re_.make_engine(backend, rc.LPConfig(**kw), fused_superstep=False).run(
        net, F0=F0
    )
    got = te.make_engine(
        backend, tc.LPConfig(**kw), device="cpu", fused_superstep=False
    ).run(pnet, F0=F0)
    _agree(got, want, net, F32_TOL)


DHLP1_CASES = {
    "fixed": dict(),
    "drift": dict(seed_mode="drift"),
    "seed_chunk": dict(seed_chunk=40),
    "bf16": dict(storage_dtype="bf16"),
    "warm_start": dict(),
}


@pytest.mark.parametrize("case", sorted(DHLP1_CASES))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_sparse_dhlp1_matches_reference(nets, fused, case):
    net, pnet = nets
    kw = dict(alg="dhlp1", sigma=1e-4, autotune=False, **DHLP1_CASES[case])
    F0 = _warm_start(net) if case == "warm_start" else None
    want = re_.make_engine("sparse", rc.LPConfig(**kw), fused_superstep=fused).run(
        net, F0=F0
    )
    got = te.make_engine(
        "sparse", tc.LPConfig(**kw), device="cpu", fused_superstep=fused
    ).run(pnet, F0=F0)
    bf16_fused = fused and case == "bf16"
    _agree(got, want, net, BF16_TOL if bf16_fused else F32_TOL)
    assert got.inner_iters > 0


def test_dhlp1_bf16_hetero_injection_is_rounded_to_bf16(nets):
    """With bf16 storage the fused DHLP-1 loop's hetero injection returns
    bf16 (the round takes the gather panel's dtype), so the inner loop
    starts from a bf16-rounded ``Yp`` — as in the reference, bit for bit."""
    import jax.numpy as jnp
    import torch

    from repro.kernels.segment_reduce import csr_round_ref as jax_round
    from repro_torch.engine.sparse import _het_injection

    net, pnet = nets
    kw = dict(alg="dhlp1", sigma=1e-4, autotune=False, storage_dtype="bf16")
    w_eng = re_.make_engine("sparse", rc.LPConfig(**kw))
    g_eng = te.make_engine("sparse", tc.LPConfig(**kw), device="cpu")
    _, w_het, w_map, w_reorder, w_perm, _ = w_eng.prepare(net).payload.split_plan
    _, g_het, g_map, g_reorder, g_perm, _ = g_eng.prepare(pnet).payload.split_plan
    rng = np.random.default_rng(3)
    F = rng.random((net.num_nodes, 6)).astype(np.float32)
    src = rng.random((net.num_nodes, 6)).astype(np.float32)

    Fp, srcp = (torch.from_numpy(a)[g_perm] for a in (F, src))
    got = _het_injection(g_het, g_map, g_reorder, Fp, srcp, beta=0.5, storage="bf16")
    assert got.dtype == torch.bfloat16

    jF = jnp.asarray(F)[w_perm].astype(jnp.bfloat16)
    jsrc = jnp.asarray(src)[w_perm][w_map]
    parts, off = [], 0
    for nbr, wgt in w_het:
        m = nbr.shape[0]
        parts.append(jax_round(nbr, wgt, jF, jsrc[off : off + m], 0.5))
        off += m
    want = jnp.concatenate(parts, axis=0)[w_reorder]
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


@pytest.mark.parametrize(
    "backend,alg", [("kernel", "dhlp2"), ("sparse", "dhlp2"), ("sparse", "dhlp1")]
)
def test_legacy_round_with_residual_matches_reference(nets, backend, alg):
    net, pnet = nets
    kw = dict(alg=alg, seed_mode="fixed", autotune=False)
    Y = rc.seeds_for_nodes(net.num_nodes, [0, 3, 60, 100, 117])
    F = Y + np.random.default_rng(2).random(Y.shape) * 0.1
    w_eng = re_.make_engine(backend, rc.LPConfig(**kw), fused_superstep=False)
    g_eng = te.make_engine(
        backend, tc.LPConfig(**kw), device="cpu", fused_superstep=False
    )
    w_out, w_delta = w_eng.round_with_residual(w_eng.prepare(net), F, Y)
    g_out, g_delta = g_eng.round_with_residual(g_eng.prepare(pnet), F, Y)
    np.testing.assert_allclose(g_out, w_out, **F32_TOL)
    np.testing.assert_allclose(g_delta, w_delta, **F32_TOL)
    np.testing.assert_allclose(g_eng.round(g_eng.prepare(pnet), F, Y), w_out, **F32_TOL)


@pytest.mark.parametrize("alg", ["dhlp1", "dhlp2"])
def test_fused_matches_legacy_inside_the_port(alg):
    """The reference's own fused-vs-legacy gate
    (``tests/test_autotune_fused.py::test_fused_matches_legacy``)."""
    from repro_torch.data import DrugNetSpec, make_drugnet

    norm = make_drugnet(
        DrugNetSpec(n_drug=48, n_disease=32, n_target=24, n_clusters=6)
    ).network.normalize()
    Y = np.eye(norm.num_nodes, dtype=np.float32)[:, :12]
    cfg = tc.LPConfig(alg=alg, sigma=1e-4, seed_mode="fixed", autotune=False)
    ref = te.make_engine("sparse", cfg, device="cpu", fused_superstep=False).run(
        norm, seeds=Y
    )
    got = te.make_engine("sparse", cfg, device="cpu").run(norm, seeds=Y)
    np.testing.assert_allclose(got.F, ref.F, rtol=1e-5, atol=1e-6)
    assert got.outer_iters == ref.outer_iters


@pytest.mark.parametrize("bad", [-1, 4])
def test_legacy_upload_rejects_out_of_range_neighbors(bad):
    """The CUDA kernel gathers neighbor ids unchecked; the upload checks."""
    from types import SimpleNamespace

    from repro_torch.core.blocked_csr import WidthBucket
    from repro_torch.engine.sparse import _device_buckets

    nbr = np.array([[0, 1], [2, 3], [1, 0], [3, 2]], dtype=np.int32)
    wgt = np.ones((4, 2), dtype=np.float32)
    rows = np.arange(4, dtype=np.int32)
    good = SimpleNamespace(width_buckets=lambda: [WidthBucket(2, rows, nbr, wgt)])
    assert len(_device_buckets(good, "cpu")[0]) == 1
    nbr = nbr.copy()
    nbr[2, 1] = bad
    broken = SimpleNamespace(width_buckets=lambda: [WidthBucket(2, rows, nbr, wgt)])
    with pytest.raises(ValueError, match="out of range"):
        _device_buckets(broken, "cpu")
