"""Port host core vs the JAX reference: exact equality on identical inputs.

Everything here is numpy in both packages, so parity is bit for bit:
generated networks, normalized blocks, blocked-CSR slots, the sparse
engine's permuted-space plan, the output stage, and the numpy oracles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.scenarios as rs
import repro_torch.api as tapi
import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.obs as tobs
import repro_torch.scenarios as ts
from repro.core.blocked_csr import blocked_csr_from_network as jax_bcsr
from repro.engine.sparse import _device_plan as jax_device_plan
from repro.engine.sparse import _tighten_buckets as jax_tighten
from repro_torch.core.blocked_csr import blocked_csr_from_network
from repro_torch.engine.sparse import _device_plan, _tighten_buckets
from repro_torch.obs import profiler as tprof


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _port_net(net):
    return tc.from_numpy(net.P, net.R, net.type_names)


@pytest.fixture(scope="module")
def bio():
    return rs.generate("bio_tri", scale=0.25, seed=0, cache=False).network


@pytest.mark.parametrize("name", ["bio_tri", "kpartite5", "powerlaw"])
def test_generated_networks_bit_identical(name):
    want = rs.generate(name, scale=0.05, seed=3, cache=False)
    got = ts.generate(name, scale=0.05, seed=3, cache=False)
    assert got.network.sizes == want.network.sizes
    assert tuple(got.network.type_names) == tuple(want.network.type_names)
    for p, q in zip(got.network.P, want.network.P):
        _same(p, q)
    assert sorted(got.network.R) == sorted(want.network.R)
    for k in want.network.R:
        _same(got.network.R[k], want.network.R[k])
        _same(got.truth[k], want.truth[k])
    for a, b in zip(got.clusters, want.clusters):
        _same(a, b)
    assert got.eval_pair == want.eval_pair
    assert got.describe() == want.describe()


def test_scenario_registry_holds_the_ported_scenarios():
    ported = {"bio_tri", "bipartite", "kpartite5", "kpartite_heterophilic", "powerlaw",
              "streaming", "streaming_chaos"}
    assert set(ts.available_scenarios()) == ported
    assert set(rs.available_scenarios()) == ported  # every scenario is ported


def test_normalize_blocks_identical(bio):
    want = bio.normalize()
    got = _port_net(bio).normalize()
    assert got.sizes == want.sizes
    for a, b in zip(got.S_homo, want.S_homo):
        _same(a, b)
    for k in want.S_het:
        _same(got.S_het[k], want.S_het[k])
    for a, b in zip(got.assemble_dense(), want.assemble_dense()):
        _same(a, b)


@pytest.mark.parametrize("layout", [(64, 8), (32, 4)])
def test_blocked_csr_slots_identical(bio, layout):
    br, wm = layout
    kw = dict(alpha=0.5, hetero_scale=0.5, block_rows=br, width_mult=wm)
    want = jax_bcsr(bio.normalize(), **kw)
    got = blocked_csr_from_network(_port_net(bio).normalize(), **kw)
    for field in ("col_idx", "val", "row_ptr", "widths"):
        _same(getattr(got, field), getattr(want, field))
    assert (got.num_rows, got.num_cols, got.block_rows) == (
        want.num_rows,
        want.num_cols,
        want.block_rows,
    )
    split_want = rc.split_blocked_csr_from_network(bio.normalize(), hetero_scale=0.5)
    split_got = tc.split_blocked_csr_from_network(
        _port_net(bio).normalize(), hetero_scale=0.5
    )
    for g, w in zip(split_got, split_want):
        _same(g.col_idx, w.col_idx)
        _same(g.val, w.val)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_plan_arrays_identical(bio, storage):
    kw = dict(alpha=0.5, hetero_scale=0.5, block_rows=64, width_mult=8)
    want_b = jax_bcsr(bio.normalize(), **kw)
    got_b = blocked_csr_from_network(_port_net(bio).normalize(), **kw)
    for (gr, gn, gw), (wr, wn, ww) in zip(
        _tighten_buckets(got_b.width_buckets()),
        jax_tighten(want_b.width_buckets()),
        strict=True,
    ):
        _same(gr, wr)
        _same(gn, wn)
        _same(gw, ww)
    w_buckets, w_perm, w_rank = jax_device_plan(want_b, storage=storage)
    g_buckets, g_perm, g_rank = _device_plan(got_b, storage=storage, device="cpu")
    _same(g_perm.numpy().astype(np.int32), w_perm)
    _same(g_rank.numpy().astype(np.int32), w_rank)
    wdt = {"f32": torch.float32, "bf16": torch.bfloat16}[storage]
    for (gn, gw, gl), (wn, ww) in zip(g_buckets, w_buckets, strict=True):
        _same(gn.numpy(), wn)
        assert gw.dtype == wdt
        _same(gw.float().numpy(), np.asarray(ww.astype(jnp.float32)))
        # the port's buckets also carry each row's live slot count
        assert gl.slots == int(np.count_nonzero(np.asarray(ww.astype(jnp.float32))))


def test_extract_outputs_and_topk_identical(bio):
    norm_w = bio.normalize()
    norm_g = _port_net(bio).normalize()
    F = np.random.default_rng(0).random((bio.num_nodes, bio.num_nodes))
    want = rc.extract_outputs(F, norm_w)
    got = tc.extract_outputs(F, norm_g)
    for a, b in zip(got.similarities, want.similarities):
        _same(a, b)
    for k in want.interactions:
        _same(got.interactions[k], want.interactions[k])
        _same(
            got.ranked_candidates(k, 3, top_k=7), want.ranked_candidates(k, 3, top_k=7)
        )
    R = bio.R[(0, 2)]
    scores = got.interactions[(0, 2)]
    for d in range(R.shape[0]):
        for excl in (R[d] > 0, np.flatnonzero(R[d]), None):
            _same(
                tc.topk_exclusive(scores[d], 10, excl),
                rc.topk_exclusive(scores[d], 10, excl),
            )
        assert tc.rank_of(scores[d], 0) == rc.rank_of(scores[d], 0)


def _ranking_row(n, kind, rng):
    """A score row of length ``n``: quantised to a few levels (ties across
    the cut), with ±inf entries, with NaNs, or all distinct."""
    if kind == "distinct":
        return rng.random(n)
    row = rng.integers(0, 4, n).astype(np.float64) / 4
    if kind == "inf":
        row[rng.integers(0, n, 1 + n // 40)] = np.inf
        row[rng.integers(0, n, 1 + n // 40)] = -np.inf
    elif kind == "nan":
        row[rng.integers(0, n, 1 + n // 60)] = np.nan
    return row


def _ranking_exclude(n, kind, rng):
    if kind == "none":
        return None
    if kind == "mask":
        return rng.random(n) < 0.1
    if kind == "repeats":
        idx = rng.integers(0, n, 1 + n // 10)
        return np.concatenate([idx, idx[: len(idx) // 2]])
    return np.ones(n, dtype=bool)  # "all": nothing left to rank


@pytest.mark.parametrize("exclude", ["none", "mask", "repeats", "all"])
@pytest.mark.parametrize("kind", ["distinct", "quantised", "inf", "nan"])
@pytest.mark.parametrize("n", [1, 892, 4396])
def test_topk_exclusive_matches_reference_index_for_index(n, kind, exclude):
    rng = np.random.default_rng(n * 131 + len(kind) * 7 + len(exclude))
    tel = tobs.Telemetry("metrics", run_id="topk")
    tprof.install_kernel_hook(tel)
    try:
        for _ in range(3):
            row = _ranking_row(n, kind, rng)
            excl = _ranking_exclude(n, exclude, rng)
            keep = np.ones(n, dtype=bool)
            if excl is not None:
                keep[excl] = False
            kept = int(keep.sum())
            for k in sorted({0, 1, 20, max(kept - 1, 0), kept, n, n + 5}):
                _same(tc.topk_exclusive(row, k, excl), rc.topk_exclusive(row, k, excl))
                # float32 rows are widened first, in both
                _same(tc.topk_exclusive(row.astype(np.float32), k, excl),
                      rc.topk_exclusive(row.astype(np.float32), k, excl))
    finally:
        tprof.uninstall_kernel_hook()
    paths = {p: getattr(tel.metrics.peek(f"rank.topk.{p}"), "value", 0)
             for p in ("select", "full_sort")}
    if n > 1 and exclude != "all" and kind != "nan":  # a row to select from
        assert paths["select"] > 0
    assert paths["full_sort"] > 0  # k = 0 and k past the kept count


def test_extract_outputs_builds_each_block_of_the_symmetrized_F():
    sizes = (13, 9, 5)
    rng = np.random.default_rng(4)
    P = [rng.random((m, m)) for m in sizes]
    P = [(p + p.T) / 2 for p in P]
    R = {(i, j): (rng.random((sizes[i], sizes[j])) < 0.3).astype(np.float64)
         for i in range(3) for j in range(i + 1, 3)}
    norm = tc.from_numpy(P, R).normalize()
    n = sum(sizes)
    F = rng.standard_normal((n, n)) * 10.0 ** rng.integers(-300, 300, (n, n))
    F[0, 1], F[1, 0], F[2, 3] = np.inf, -np.inf, -0.0
    whole = tc.symmetrize(F)
    sl = norm.block_slices()
    got = tc.extract_outputs(F, norm)
    assert len(got.similarities) == 3 and sorted(got.interactions) == [(0, 1), (0, 2), (1, 2)]
    blocks = [(block, whole[sl[i], sl[i]]) for i, block in enumerate(got.similarities)]
    blocks += [(block, whole[sl[i], sl[j]]) for (i, j), block in got.interactions.items()]
    for block, want in blocks:  # bit for bit: signed zeros, infinities, NaN
        _same(block.view(np.int64), want.view(np.int64))
        assert block.base is None and block.flags.c_contiguous  # its own array
    with pytest.raises(ValueError, match="square"):
        tc.extract_outputs(F[:, :-1], norm)
    with pytest.raises(ValueError, match="square"):
        tc.symmetrize(F[:-1])


def test_oracles_identical(bio):
    norm_w = bio.normalize()
    norm_g = _port_net(bio).normalize()
    H, M = norm_w.assemble_dense()
    Y = rc.seeds_for_nodes(bio.num_nodes, [0, 5, 77])
    _same(
        tc.fixed_seed_solution(H, M, Y, 0.5), rc.fixed_seed_solution(H, M, Y, 0.5)
    )
    _same(
        tc.dhlp1_inner_solution(M[:56, :56], Y[:56], 0.5),
        rc.dhlp1_inner_solution(M[:56, :56], Y[:56], 0.5),
    )
    for fn in ("minprop_single_seed", "heterlp_single_seed"):
        got = getattr(tc, fn)(norm_g, Y[:, 1], sigma=1e-3)
        want = getattr(rc, fn)(norm_w, Y[:, 1], sigma=1e-3)
        _same(got.F, want.F)
        assert (got.outer_iters, got.inner_iters) == (want.outer_iters, want.inner_iters)
    _same(tc.seeds_identity(9), rc.seeds_identity(9))


def test_npz_round_trips_between_packages(bio, tmp_path):
    """A network saved by either package loads in the other unchanged."""
    path_w = bio.save_npz(str(tmp_path / "from_repro"))
    got = tc.HeteroNetwork.load_npz(path_w)
    path_g = got.save_npz(str(tmp_path / "from_port.npz"))
    back = rc.HeteroNetwork.load_npz(path_g)
    for net in (got, back):
        for p, q in zip(net.P, bio.P):
            _same(p, q)
        for k in bio.R:
            _same(net.R[k], bio.R[k])
        assert tuple(net.type_names) == tuple(bio.type_names)


def test_apply_delta_identical(bio):
    delta_w = rc.GraphDelta(
        assoc=(((2, 0), 3, 4, 1.0), ((0, 1), 0, 0, 0.0)),
        sim=((1, 2, 5, 0.7),),
        add_nodes={2: 2},
    )
    delta_g = tc.GraphDelta(
        assoc=delta_w.assoc, sim=delta_w.sim, add_nodes=delta_w.add_nodes
    )
    want = bio.apply_delta(delta_w)
    got = _port_net(bio).apply_delta(delta_g)
    assert got.sizes == want.sizes
    for p, q in zip(got.P, want.P):
        _same(p, q)
    for k in want.R:
        _same(got.R[k], want.R[k])
    assert delta_g.touched_types() == delta_w.touched_types()


def _dhlp2_iterates(A, Y, counts, beta2):
    """Fixed-seed DHLP-2 in float64, column j stopped after ``counts[j]`` rounds."""
    F = Y.copy()
    for k in range(1, int(counts.max()) + 1):
        on = counts >= k
        F[:, on] = beta2 * Y[:, on] + A @ F[:, on]
    return F


def _dense_runs(net, backend):
    """The solve of ``net`` in f32 and in bf16 storage, and the operator
    arrays each engine holds."""
    runs, arrays = {}, {}
    for storage in ("f32", "bf16"):
        cfg = tc.LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed", storage_dtype=storage)
        eng = te.make_engine(backend, cfg, num_nodes=net.num_nodes, device="cpu")
        runs[storage] = eng.run(net)
        op = eng.prepare(net)
        arrays[storage] = op.payload.operator_arrays(op.norm)
    return runs, arrays


def test_dense_bf16_storage_is_the_f32_solve_to_bf16_rounding():
    """The dense engine honours ``storage_dtype``: its operator in bfloat16,
    state and sums in f32.  It agrees with the f32 solve to bfloat16's
    rounding, and stands off a float64 reference by more than f32's."""
    net = ts.generate("powerlaw", scale=0.03, seed=0, cache=False).network
    runs, arrays = _dense_runs(net, "dense")
    assert arrays["f32"]["fused"][0].dtype == torch.float32
    for A in (*arrays["bf16"]["split"], arrays["bf16"]["fused"][0]):
        assert A.dtype == torch.bfloat16
    assert runs["bf16"].F.dtype == np.float64
    f32, bf16 = runs["f32"].F, runs["bf16"].F
    gap = np.abs(bf16 - f32).max() / np.abs(f32).max()
    assert 2.0**-16 < gap < 2.0**-8  # rounded, by less than one bfloat16 step

    norm = net.normalize()
    H, M = norm.assemble_dense()
    H = H * tc.LPConfig().resolved_hetero_scale(norm.num_types)
    A = 0.5 * 0.5 * H + 0.5 * M
    Y = np.eye(norm.num_nodes)

    def f_err(res):
        ref = _dhlp2_iterates(A, Y, np.asarray(res.per_column_iters), 0.25)
        return np.abs(res.F - ref).max() / np.abs(ref).max()

    # f32 within a few f32 steps of the reference; bf16 past any of them,
    # and within one bfloat16 step
    assert f_err(runs["f32"]) < 2.0**-20 < 2.0**-16 < f_err(runs["bf16"]) < 2.0**-8


def test_auto_with_bf16_storage_takes_the_dense_engine_in_bfloat16():
    """``auto`` sends a network of at most ``AUTO_DENSE_MAX_NODES`` nodes to
    the dense engine, which now reads ``storage_dtype``: a bf16 request there
    gets the bfloat16 operator, and the f32 request the exact one."""
    net = ts.generate("powerlaw", scale=0.03, seed=0, cache=False).network
    assert net.num_nodes <= te.AUTO_DENSE_MAX_NODES
    spec = tapi.SolveSpec(alg="dhlp2", sigma=1e-4, seed_mode="fixed", storage_dtype="bf16")
    cfg = spec.to_lp_config()
    assert cfg.backend is None and cfg.storage_dtype == "bf16"
    eng = te.make_engine(None, cfg, num_nodes=net.num_nodes, device="cpu")
    assert eng.name == "dense"
    runs, arrays = _dense_runs(net, None)
    assert arrays["bf16"]["fused"][0].dtype == torch.bfloat16
    assert arrays["f32"]["fused"][0].dtype == torch.float32
    want, _ = _dense_runs(net, "dense")
    for storage in ("f32", "bf16"):
        np.testing.assert_array_equal(runs[storage].F, want[storage].F)
