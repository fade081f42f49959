"""The port's graph substrate vs the JAX reference, on the CPU.

Generators, containers, the neighbour sampler, the partitioners and the
GNN data helpers compute in numpy in both packages: their arrays must be
bit-equal for the same seeds (``repro_torch`` sorts on the device it is
given, here the CPU).  ``segment_min`` and ``layer_norm`` are held to
``repro``'s at f32 precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jax_graphs
from repro.graph import partition as jax_partition
from repro.graph import sampler as jax_sampler
from repro.graph import segment as jax_segment
from repro.graph import structures as jax_structures
from repro.models import common as jax_common
from repro.models import gnn as jax_gnn
import repro_torch.graph as port_graph
from repro_torch.data import graphs
from repro_torch.graph import partition, sampler, segment, structures
from repro_torch.models import common
from repro_torch.models.gnn import build_triplets


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _same_edges(mine, ref):
    assert mine.num_nodes == ref.num_nodes
    _same(mine.src, ref.src)
    _same(mine.dst, ref.dst)
    if ref.w is None:
        assert mine.w is None
    else:
        _same(mine.w, ref.w)


def _port(e):
    return structures.EdgeList(e.src, e.dst, e.w, e.num_nodes)


class TestGenerators:
    @pytest.mark.parametrize(
        "n,e,seed,weighted", [(50, 300, 0, True), (300, 2000, 7, True), (40, 500, 3, False),
                              (1, 10, 1, True), (10, 0, 0, True)]
    )
    def test_erdos_renyi_is_bit_equal(self, n, e, seed, weighted):
        _same_edges(
            structures.erdos_renyi(n, e, seed=seed, weighted=weighted, device="cpu"),
            jax_structures.erdos_renyi(n, e, seed=seed, weighted=weighted),
        )

    @pytest.mark.parametrize(
        "n,e,exponent,seed", [(100, 2000, 2.1, 0), (500, 5000, 2.1, 3), (60, 900, 1.5, 2)]
    )
    def test_powerlaw_graph_is_bit_equal(self, n, e, exponent, seed):
        _same_edges(
            structures.powerlaw_graph(n, e, exponent=exponent, seed=seed, device="cpu"),
            jax_structures.powerlaw_graph(n, e, exponent=exponent, seed=seed),
        )

    def test_generators_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            structures.erdos_renyi(10, 20)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            structures.powerlaw_graph(10, 20)


EDGE_CASES = {
    "weighted": lambda: jax_structures.erdos_renyi(80, 600, seed=2),
    "unweighted": lambda: jax_structures.powerlaw_graph(70, 400, seed=4),
    "unsorted": lambda: jax_structures.EdgeList(
        src=np.random.default_rng(5).integers(0, 30, 200),
        dst=np.random.default_rng(6).integers(0, 30, 200),
        w=np.random.default_rng(7).random(200), num_nodes=30),
}


class TestEdgeList:
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_sort_and_degrees_are_bit_equal(self, case):
        ref = EDGE_CASES[case]()
        mine = _port(ref)
        _same_edges(mine.sorted_by_dst(device="cpu"), ref.sorted_by_dst())
        _same(mine.in_degrees(), ref.in_degrees())
        _same(mine.out_degrees(), ref.out_degrees())

    @pytest.mark.parametrize("mult", [1, 7, 64, 1000])
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_pad_to_multiple_is_bit_equal(self, case, mult):
        ref = EDGE_CASES[case]()
        _same_edges(_port(ref).pad_to_multiple(mult), ref.pad_to_multiple(mult))

    def test_pad_to_multiple_of_an_empty_graph(self):
        ref = jax_structures.EdgeList(np.zeros(0, np.int32), np.zeros(0, np.int32), None, 3)
        _same_edges(_port(ref).pad_to_multiple(4), ref.pad_to_multiple(4))

    @pytest.mark.parametrize("max_deg", [None, 3])
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_to_padded_csr_is_bit_equal(self, case, max_deg):
        ref = EDGE_CASES[case]()
        got = _port(ref).to_padded_csr(max_deg=max_deg, device="cpu")
        want = ref.to_padded_csr(max_deg=max_deg)
        for name in ("nbr", "wgt", "deg"):
            _same(getattr(got, name), getattr(want, name))
        assert got.num_nodes == want.num_nodes


def _sampler_graph():
    # node 0..4 have no in-edges: their sampled rows are all pads
    g = jax_structures.erdos_renyi(400, 3000, seed=11)
    keep = g.dst >= 5
    return jax_structures.EdgeList(g.src[keep], g.dst[keep], g.w[keep], 400)


class TestSampler:
    def test_csr_adjacency_is_bit_equal(self):
        ref = _sampler_graph()
        got = sampler.CSRAdjacency.from_edgelist(_port(ref), device="cpu")
        want = jax_sampler.CSRAdjacency.from_edgelist(ref)
        _same(got.indptr, want.indptr)
        _same(got.cols, want.cols)
        nodes = np.array([0, 3, 7, 399])
        _same(got.degree(nodes), want.degree(nodes))

    @pytest.mark.parametrize("fanouts,seed", [((15, 10), 0), ((3,), 5), ((4, 3, 2), 9)])
    def test_sample_and_relabel_are_bit_equal(self, fanouts, seed):
        ref = _sampler_graph()
        seeds = np.random.default_rng(seed).choice(400, 24, replace=False)
        seeds[:2] = [0, 1]  # two seeds without in-edges
        mine = sampler.NeighborSampler(
            sampler.CSRAdjacency.from_edgelist(_port(ref), device="cpu"), fanouts, seed=seed)
        theirs = jax_sampler.NeighborSampler(
            jax_sampler.CSRAdjacency.from_edgelist(ref), fanouts, seed=seed)
        for _ in range(2):  # the generator's state carries across batches
            got, want = mine.sample(seeds), theirs.sample(seeds)
            _same(got.seeds, want.seeds)
            _same(got.all_nodes, want.all_nodes)
            assert len(got.blocks) == len(want.blocks) == len(fanouts)
            for a, b in zip(got.blocks, want.blocks):
                for name in ("nodes", "nbr", "mask", "unique_nbrs"):
                    _same(getattr(a, name), getattr(b, name))
            nodes_a, hops_a = sampler.relabel_to_local(got)
            nodes_b, hops_b = jax_sampler.relabel_to_local(want)
            _same(nodes_a, nodes_b)
            for ha, hb in zip(hops_a, hops_b):
                for x, y in zip(ha, hb):
                    _same(x, y)


class TestPartition:
    @pytest.mark.parametrize("k", [1, 3, 4, 7])
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_edge_partition_is_bit_equal(self, case, k):
        ref = EDGE_CASES[case]()
        got = partition.edge_partition(_port(ref), k, device="cpu")
        want = jax_partition.edge_partition(ref, k)
        for name in ("src", "dst", "w"):
            _same(getattr(got, name), getattr(want, name))
        assert (got.num_shards, got.edges_per_shard, got.num_nodes) == (
            want.num_shards, want.edges_per_shard, want.num_nodes)

    @pytest.mark.parametrize("n,k", [(10, 3), (100, 4), (5, 8), (0, 2), (64, 1)])
    def test_node_partition_is_bit_equal(self, n, k):
        got, want = partition.node_partition(n, k), jax_partition.node_partition(n, k)
        _same(got.bounds, want.bounds)
        nodes = np.arange(max(n, 1)) % max(n, 1)
        _same(got.owner_of(nodes), want.owner_of(nodes))

    @pytest.mark.parametrize("k", [1, 2, 5])
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_balance_report_is_equal(self, case, k):
        ref = EDGE_CASES[case]()
        assert partition.balance_report(_port(ref), k) == jax_partition.balance_report(ref, k)


class TestData:
    @pytest.mark.parametrize(
        "kw", [dict(batch=4), dict(batch=3, nodes_per=10, edges_per=12, seed=5),
               dict(batch=2, nodes_per=8, edges_per=30, n_species=4, seed=1)]
    )
    def test_molecule_batch_is_bit_equal(self, kw):
        got, want = graphs.molecule_batch(**kw), jax_graphs.molecule_batch(**kw)
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])

    @pytest.mark.parametrize(
        "kw", [dict(n_nodes=50, n_edges=200), dict(n_nodes=7, n_edges=40, d_node=3, d_edge=2,
                                                    d_out=5, seed=4)]
    )
    def test_mesh_rollout_batch_is_bit_equal(self, kw):
        got, want = graphs.mesh_rollout_batch(**kw), jax_graphs.mesh_rollout_batch(**kw)
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])

    @pytest.mark.parametrize("cap", [None, 10, 100_000])
    @pytest.mark.parametrize("source", ["molecule", "random"])
    def test_build_triplets_is_bit_equal(self, source, cap):
        if source == "molecule":
            b = graphs.molecule_batch(3, seed=2)
            src, dst, n = b["src"], b["dst"], int(b["z"].shape[0])
        else:
            g = jax_structures.erdos_renyi(40, 300, seed=8)
            src, dst, n = g.src, g.dst, 40
        got = build_triplets(src, dst, n, max_triplets=cap)
        want = jax_gnn.build_triplets(src, dst, n, max_triplets=cap)
        for a, b in zip(got, want):
            _same(a, b)


class TestHelpers:
    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    @pytest.mark.parametrize("shape", [(50,), (50, 3)])
    def test_segment_min_is_the_reference(self, dtype, shape):
        rng = np.random.default_rng(0)
        data = (rng.normal(0, 10, shape)).astype(dtype)
        ids = rng.integers(0, 12, shape[0]).astype(np.int32)
        ids[ids == 5] = 4  # segment 5 stays empty
        want = np.asarray(jax_segment.segment_min(jnp.asarray(data), jnp.asarray(ids), 14))
        got = segment.segment_min(torch.from_numpy(data), torch.from_numpy(ids), 14).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)  # min is exact; empty segments at the top

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_layer_norm_is_the_reference(self, dtype):
        rng = np.random.default_rng(1)
        x = rng.normal(3.0, 2.0, (6, 5, 32)).astype(np.float32)
        g = rng.normal(1.0, 0.1, 32).astype(np.float32)
        b = rng.normal(0.0, 0.1, 32).astype(np.float32)
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
        want = np.asarray(jax_common.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g),
                                                jnp.asarray(b)).astype(jnp.float32))
        got = common.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                                torch.from_numpy(b))
        assert got.dtype == tdt
        tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)

    def test_graph_package_exports_the_reference_names(self):
        from repro import graph as jax_graph

        assert set(jax_graph.__all__) <= set(port_graph.__all__)
        for name in jax_graph.__all__:
            assert hasattr(port_graph, name)
