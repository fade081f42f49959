"""Port workloads vs the JAX reference: arrival processes, traces, the
streaming scenarios, ``make_scaling_network`` and two host-core methods.

Everything here is host numpy in both packages, so every comparison is
exact: the same seed must give the same arrays, bit for bit.
"""

import numpy as np
import pytest

import repro.scenarios as rs
import repro.scenarios.arrivals as ra
import repro_torch.scenarios as ts
import repro_torch.scenarios.arrivals as ta
from repro.data.drugnet import make_scaling_network as jax_make_scaling_network
from repro_torch.core import from_numpy
from repro_torch.data.drugnet import make_scaling_network

SEEDS = (0, 1)


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


def _same_trace(got, want):
    for field in ("t", "entity", "target_type"):
        _same(getattr(got, field), getattr(want, field))
    assert (got.process, got.rate_qps, got.horizon_s) == (
        want.process,
        want.rate_qps,
        want.horizon_s,
    )


def _same_meta(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            _same(got[k], v)
        else:
            assert got[k] == v, k


def _same_bundle(got, want):
    assert got.name == want.name and tuple(got.eval_pair) == tuple(want.eval_pair)
    _same_net(got.network, want.network)
    assert sorted(got.truth) == sorted(want.truth)
    for k in want.truth:
        _same(got.truth[k], want.truth[k])
    assert len(got.clusters) == len(want.clusters)
    for a, b in zip(got.clusters, want.clusters):
        _same(a, b)
    assert len(got.deltas) == len(want.deltas)
    for a, b in zip(got.deltas, want.deltas):
        assert a.t == b.t
        assert a.delta.assoc == b.delta.assoc
        assert a.delta.sim == b.delta.sim
        assert a.delta.add_nodes == b.delta.add_nodes
    assert (got.trace is None) == (want.trace is None)
    if want.trace is not None:
        _same_trace(got.trace, want.trace)
    _same_meta(got.meta, want.meta)


# ---------------------------------------------------------- arrival processes

ARRIVAL_CASES = (
    ("poisson_arrivals", (200.0, 10.0), {}),
    ("poisson_arrivals", (3.0, 0.5), {}),
    ("bursty_arrivals", (200.0, 20.0), {}),
    ("bursty_arrivals", (50.0, 4.0), {"burst_factor": 3.0, "burst_fraction": 0.4}),
    ("diurnal_arrivals", (400.0, 10.0), {"depth": 0.9}),
    ("diurnal_arrivals", (30.0, 2.0), {}),
    ("diurnal_arrivals", (60.0, 6.0), {"period_s": 2.5}),
)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,args,kw", ARRIVAL_CASES)
def test_arrival_process_identical(seed, name, args, kw):
    got = getattr(ta, name)(*args, np.random.default_rng(seed), **kw)
    want = getattr(ra, name)(*args, np.random.default_rng(seed), **kw)
    _same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("process", ra.ARRIVAL_PROCESSES)
def test_arrival_times_identical(seed, process):
    assert ta.ARRIVAL_PROCESSES == ra.ARRIVAL_PROCESSES
    got = ts.arrival_times(process, 120.0, 3.0, np.random.default_rng(seed))
    want = rs.arrival_times(process, 120.0, 3.0, np.random.default_rng(seed))
    _same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,count,skew", [(40, 500, 1.1), (7, 64, 2.0), (1, 3, 1.1)])
def test_zipf_entities_identical(seed, n, count, skew):
    got = ts.zipf_entities(n, count, np.random.default_rng(seed), skew=skew)
    want = rs.zipf_entities(n, count, np.random.default_rng(seed), skew=skew)
    _same(got, want)


def test_arrival_errors_match():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="arrival process"):
        ts.arrival_times("constant", 1.0, 1.0, rng)
    with pytest.raises(ValueError, match="must be > 0"):
        ta.poisson_arrivals(0.0, 1.0, rng)


def test_arrival_statistics():
    """tests/test_scenarios.py::TestArrivals, on the port."""
    t = ts.arrival_times("poisson", 200.0, 10.0, np.random.default_rng(0))
    assert np.all(np.diff(t) >= 0) and t[-1] < 10.0
    assert 1500 < len(t) < 2500
    t = ts.arrival_times("bursty", 200.0, 20.0, np.random.default_rng(0))
    counts, _ = np.histogram(t, bins=40)
    assert 0.6 * 4000 < len(t) < 1.4 * 4000 and counts.var() > 2.0 * counts.mean()
    t = ts.arrival_times("diurnal", 400.0, 10.0, np.random.default_rng(0), depth=0.9)
    assert (t < 5.0).sum() > 0.6 * len(t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("process", ra.ARRIVAL_PROCESSES)
@pytest.mark.parametrize("scenario,scale", [("kpartite5", 0.25), ("bio_tri", 0.3)])
def test_build_trace_identical(seed, process, scenario, scale):
    tb = ts.generate(scenario, scale=scale, seed=0, cache=False)
    rb = rs.generate(scenario, scale=scale, seed=0, cache=False)
    got = ts.build_trace(tb, process, rate_qps=100.0, horizon_s=1.5, seed=seed)
    want = rs.build_trace(rb, process, rate_qps=100.0, horizon_s=1.5, seed=seed)
    _same_trace(got, want)
    i, j = tb.eval_pair
    lo = tb.network.offsets[i]
    assert np.all((got.entity >= lo) & (got.entity < lo + tb.network.sizes[i]))
    assert np.all(got.target_type == j)


# -------------------------------------------------------- streaming scenarios


@pytest.mark.parametrize("scale", [0.5, 1.0])
@pytest.mark.parametrize("name", ["streaming", "streaming_chaos"])
def test_streaming_bundle_identical(name, scale):
    got = ts.generate(name, scale=scale, seed=0, cache=False)
    want = rs.generate(name, scale=scale, seed=0, cache=False)
    _same_bundle(got, want)
    assert got.trace is not None and len(got.deltas) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_streaming_bundle_identical_with_replay_params(seed):
    """The Session couples the replay's horizon and rate into the builder."""
    kw = dict(rate_qps=30.0, horizon_s=1.0, n_deltas=2, trace_process="poisson")
    got = ts.generate("streaming", scale=0.5, seed=seed, cache=False, **kw)
    want = rs.generate("streaming", scale=0.5, seed=seed, cache=False, **kw)
    _same_bundle(got, want)


def test_streaming_deltas_readd_heldout_edges():
    """tests/test_scenarios.py::TestStreamingScenario, on the port."""
    b = ts.generate("streaming", scale=1.0, seed=0, cache=False)
    pair = b.eval_pair
    arriving = b.meta["arriving_truth"]
    assert int(arriving.sum()) == b.meta["heldout_edges"]
    assert not np.any((b.network.R[pair] > 0) & arriving)
    assert not np.any(b.truth[pair] & arriving)
    net = b.network
    for td in b.deltas:
        net = net.apply_delta(td.delta)
    rows, cols = np.nonzero(arriving)
    assert np.all(net.R[pair][rows, cols] > 0)
    times = [td.t for td in b.deltas]
    assert times == sorted(times) and times[-1] < b.trace.horizon_s
    # one delta in the middle of the stream adds two drug nodes
    assert sum(td.delta.add_nodes.get(0, 0) for td in b.deltas) == 2


def test_scenario_exports_match():
    for name in ("ARRIVAL_PROCESSES", "arrival_times", "build_trace", "zipf_entities"):
        assert name in ts.__all__ and hasattr(ts, name)
    assert set(rs.available_scenarios()) == set(ts.available_scenarios())
    assert [r["name"] for r in ts.list_rows()] == [r["name"] for r in rs.list_rows()]


# ------------------------------------------------- scaling network, host core


def test_make_scaling_network_identical():
    got = make_scaling_network(int(2e5), seed=0)
    want = jax_make_scaling_network(int(2e5), seed=0)
    _same_net(got.network, want.network)
    assert got.spec.n_drug == want.spec.n_drug
    for a, b in zip(got.clusters, want.clusters):
        _same(a, b)
    assert sorted(got.truth) == sorted(want.truth)
    for k in want.truth:
        _same(got.truth[k], want.truth[k])


@pytest.fixture(scope="module")
def bio_tri_norms():
    rb = rs.generate("bio_tri", scale=0.3, seed=0, cache=False)
    net = from_numpy(rb.network.P, rb.network.R, rb.network.type_names)
    return net.normalize(), rb.network.normalize()


@pytest.mark.parametrize("alpha", [0.4, 0.5, 0.9])
def test_assemble_effective_identical(bio_tri_norms, alpha):
    tn, rn = bio_tri_norms
    A, beta2 = tn.assemble_effective(alpha)
    A_ref, beta2_ref = rn.assemble_effective(alpha)
    _same(A, A_ref)
    assert beta2 == beta2_ref
    H, M = tn.assemble_dense()
    np.testing.assert_allclose(A, alpha * (1 - alpha) * H + alpha * M)
    assert beta2 == pytest.approx((1 - alpha) ** 2)


@pytest.mark.parametrize("mult", [(1024, 1024), (64, 64), (7, 1)])
def test_pad_to_identical(bio_tri_norms, mult):
    tn, rn = bio_tri_norms
    coo, coo_ref = tn.to_coo(), rn.to_coo()
    got, want = coo.pad_to(*mult), coo_ref.pad_to(*mult)
    for f in ("het_src", "het_dst", "het_w", "hom_src", "hom_dst", "hom_w"):
        _same(getattr(got, f), getattr(want, f))
    assert (got.num_nodes, list(got.sizes)) == (want.num_nodes, list(want.sizes))
    e = coo.het_src.shape[0]
    assert got.het_src.shape[0] % mult[0] == 0
    assert got.het_w[e:].sum() == 0
