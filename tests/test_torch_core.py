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
import repro_torch.core as tc
import repro_torch.scenarios as ts
from repro.core.blocked_csr import blocked_csr_from_network as jax_bcsr
from repro.engine.sparse import _device_plan as jax_device_plan
from repro.engine.sparse import _tighten_buckets as jax_tighten
from repro_torch.core.blocked_csr import blocked_csr_from_network
from repro_torch.engine.sparse import _device_plan, _tighten_buckets


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
    ported = {"bio_tri", "bipartite", "kpartite5", "kpartite_heterophilic", "powerlaw"}
    assert set(ts.available_scenarios()) == ported
    assert ported <= set(rs.available_scenarios())


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
