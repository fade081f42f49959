"""The port's GCN and Wide & Deep slice vs the JAX reference, on the CPU.

Data, graph containers and segment reductions must equal ``repro``'s
(bit for bit where the reference computes in numpy); the models, with
``repro``'s parameters carried across by ``repro_torch.models.convert``,
must agree at f32 ``rtol=2e-4, atol=5e-4`` (the f32 tolerance of
``tests/test_kernels.py::_tol``).  The kernels' own sweeps are in
``test_torch_kernels.py``; the card runs in ``test_torch_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jax_cells
from repro.configs import gcn_cora as jax_gcn_cora
from repro.configs import wide_deep as jax_wide_deep
from repro.core import symmetric_normalize
from repro.data.graphs import planted_partition_graph as jax_planted
from repro.data.recsys import CTRDataConfig as JaxCTRConfig
from repro.data.recsys import sample_ctr_batch as jax_sample_ctr
from repro.graph import segment as jax_segment
from repro.graph.structures import EdgeList as JaxEdgeList
from repro.graph.structures import PaddedCSR as JaxPaddedCSR
from repro.graph.structures import erdos_renyi, powerlaw_graph
from repro.models import gnn as jax_gnn
from repro.models import recsys as jax_recsys
from repro_torch.configs import cells, gcn_cora, wide_deep
from repro_torch.data.graphs import planted_partition_graph
from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
from repro_torch.graph import segment
from repro_torch.graph.structures import EdgeList, PaddedCSR
from repro_torch.kernels import launch_counts
from repro_torch.models.convert import load_gcn, load_widedeep
from repro_torch.models.gnn import GCN, gcn_adjacency, gcn_forward
from repro_torch.models.recsys import WideDeep, make_retrieval_scorer, make_serve

F32_TOL = dict(rtol=2e-4, atol=5e-4)


def _port(e: JaxEdgeList) -> EdgeList:
    return EdgeList(e.src, e.dst, e.w, e.num_nodes)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_edges(mine: EdgeList, ref: JaxEdgeList):
    assert mine.num_nodes == ref.num_nodes
    _same(mine.src, ref.src)
    _same(mine.dst, ref.dst)
    if ref.w is None:
        assert mine.w is None
    else:
        _same(mine.w, ref.w)


GRAPHS = {
    "erdos_renyi": lambda: erdos_renyi(150, 800, seed=3),
    "erdos_renyi_unweighted": lambda: erdos_renyi(90, 400, seed=5, weighted=False),
    "powerlaw": lambda: powerlaw_graph(200, 1500, seed=1),
}


class TestGraphContainers:
    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    def test_transforms_are_bit_identical(self, graph):
        ref = GRAPHS[graph]()
        mine = _port(ref)
        _same_edges(mine.symmetrized(device="cpu"), ref.symmetrized())
        _same_edges(mine.with_self_loops(), ref.with_self_loops())
        _same_edges(
            mine.symmetrized(device="cpu").with_self_loops(),
            ref.symmetrized().with_self_loops(),
        )
        _same(mine.to_dense(), ref.to_dense())
        _same_edges(EdgeList.from_dense(ref.to_dense()), JaxEdgeList.from_dense(ref.to_dense()))

    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    @pytest.mark.parametrize("max_deg", [None, 3])
    def test_padded_csr_is_bit_identical(self, graph, max_deg):
        ref = GRAPHS[graph]()
        want = JaxPaddedCSR.from_edgelist(ref, max_deg=max_deg)
        got = PaddedCSR.from_edgelist(_port(ref), max_deg=max_deg, device="cpu")
        assert got.num_nodes == want.num_nodes and got.max_deg == want.max_deg
        for name in ("nbr", "wgt", "deg"):
            _same(getattr(got, name), getattr(want, name))

    def test_padded_csr_of_an_edgeless_graph(self):
        empty = JaxEdgeList(np.zeros(0, np.int32), np.zeros(0, np.int32), None, 5)
        want = JaxPaddedCSR.from_edgelist(empty)
        got = PaddedCSR.from_edgelist(_port(empty), device="cpu")
        for name in ("nbr", "wgt", "deg"):
            _same(getattr(got, name), getattr(want, name))

    def test_device_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port(erdos_renyi(10, 20)).symmetrized()


class TestData:
    @pytest.mark.parametrize(
        "n,e,c,d,seed",
        [(512, 2048, 4, 32, 0), (3000, 20000, 47, 8, 1), (400, 1000, 600, 4, 2)],
    )
    def test_planted_partition_is_bit_identical(self, n, e, c, d, seed):
        want = jax_planted(n_nodes=n, n_edges=e, n_classes=c, d_feat=d, seed=seed)
        got = planted_partition_graph(
            n_nodes=n, n_edges=e, n_classes=c, d_feat=d, seed=seed, device="cpu"
        )
        _same_edges(got.edges, want.edges)
        for name in ("feats", "labels", "train_mask"):
            _same(getattr(got, name), getattr(want, name))
        assert got.n_classes == want.n_classes

    @pytest.mark.parametrize("step", [0, 3])
    def test_ctr_batch_is_bit_identical(self, step):
        want = jax_sample_ctr(JaxCTRConfig(40, 13, 1_000_000, seed=0), 256, step)
        got = sample_ctr_batch(CTRDataConfig(40, 13, 1_000_000, seed=0), 256, step)
        assert set(got) == set(want)
        for name in want:
            _same(got[name], want[name])


class TestSegment:
    @staticmethod
    def _inputs(seed=0):
        rng = np.random.default_rng(seed)
        ids = np.sort(rng.integers(0, 12, 90)).astype(np.int32)
        ids = ids[ids != 7]  # segment 7 stays empty
        data = rng.normal(size=(ids.size, 5)).astype(np.float32)
        return ids, data

    @pytest.mark.parametrize("name", ["segment_sum", "segment_mean", "segment_max"])
    def test_reductions(self, name):
        ids, data = self._inputs()
        want = np.asarray(getattr(jax_segment, name)(jnp.asarray(data), jnp.asarray(ids), 12))
        got = getattr(segment, name)(torch.from_numpy(data), torch.from_numpy(ids), 12)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def test_softmax_and_degree(self):
        ids, data = self._inputs(1)
        scores = data[:, 0]
        want = np.asarray(jax_segment.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), 12))
        got = segment.segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids), 12)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        _same(
            segment.degree(torch.from_numpy(ids), 12).numpy(),
            np.asarray(jax_segment.degree(jnp.asarray(ids), 12)),
        )

    def test_scatter_spmm(self):
        e = erdos_renyi(60, 300, seed=4)
        F = np.random.default_rng(4).random((60, 7)).astype(np.float32)
        want = np.asarray(
            jax_segment.scatter_spmm(
                jnp.asarray(e.src), jnp.asarray(e.dst), jnp.asarray(e.w), jnp.asarray(F), 60
            )
        )
        got = segment.scatter_spmm(*(torch.from_numpy(a) for a in (e.src, e.dst, e.w, F)), 60)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), e.to_dense() @ F, rtol=1e-5, atol=1e-6)

    def test_gcn_norm_is_the_dense_construction(self):
        """``D^{-1/2} A D^{-1/2}`` over the edge list equals the reference's
        dense ``symmetric_normalize`` + ``EdgeList.from_dense`` (the graph of
        ``build_gnn_job``; duplicate self-loops stay two entries)."""
        data = jax_planted(n_nodes=512, n_edges=2048, n_classes=4, d_feat=32, seed=0)
        e = data.edges
        want = JaxEdgeList.from_dense(symmetric_normalize(e.to_dense()))
        wn = segment.gcn_norm(*(torch.from_numpy(a) for a in (e.src, e.dst, e.weights())), 512)
        got = EdgeList(e.src, e.dst, wn.numpy(), 512)
        assert got.num_edges > want.num_edges  # some self-loops were doubled
        np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=1e-6, atol=0)


def _gnn_job_graph():
    """The 512-node graph and operator of ``repro.launch.train.build_gnn_job``."""
    cfg = jax_gcn_cora.REDUCED
    data = jax_planted(n_nodes=512, n_edges=2048, n_classes=cfg.n_classes,
                       d_feat=cfg.d_feat, seed=0)
    el = JaxEdgeList.from_dense(symmetric_normalize(data.edges.to_dense()))
    return data, el


class TestGCN:
    def test_reduced_logits_match_the_reference(self):
        cfg = jax_gcn_cora.REDUCED
        data, el = _gnn_job_graph()
        params = jax_gnn.gcn_init(cfg, jax.random.PRNGKey(0))
        want = np.asarray(
            jax_gnn.gcn_forward(
                cfg, params, jnp.asarray(data.feats), jnp.asarray(el.src),
                jnp.asarray(el.dst), jnp.asarray(el.weights()), 512,
            )
        )
        model = load_gcn(GCN(gcn_cora.REDUCED, device="cpu"), jax.tree.map(np.asarray, params))
        mine = planted_partition_graph(
            n_nodes=512, n_edges=2048, n_classes=4, d_feat=32, seed=0, device="cpu"
        )
        nbr, wgt = gcn_adjacency(mine.edges, device="cpu")
        before = launch_counts()
        got = model(torch.from_numpy(mine.feats), nbr, wgt)
        assert launch_counts() == before  # CPU tensors: the plain version
        assert got.shape == (512, 4) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        # the functional COO forward, on the reference's own operator
        coo = gcn_forward(
            gcn_cora.REDUCED,
            {"w": list(model.weights), "b": list(model.biases)},
            torch.from_numpy(mine.feats),
            *(torch.from_numpy(a) for a in (el.src, el.dst, el.weights())),
            512,
        )
        np.testing.assert_allclose(coo.numpy(), want, **F32_TOL)

    def test_plain_path_equals_kernel_path_on_the_cpu(self):
        data = planted_partition_graph(300, 1200, 5, 12, seed=3, device="cpu")
        nbr, wgt = gcn_adjacency(data.edges, device="cpu")
        cfg = dataclasses.replace(gcn_cora.REDUCED, d_feat=12, n_classes=5)
        a = GCN(cfg, device="cpu")
        b = GCN(cfg, device="cpu", use_kernel=False)
        b.load_state_dict(a.state_dict())
        feats = torch.from_numpy(data.feats)
        assert torch.equal(a(feats, nbr, wgt), b(feats, nbr, wgt))

    def test_adjacency_is_the_padded_csr_of_the_normalized_graph(self):
        data, el = _gnn_job_graph()
        mine = planted_partition_graph(512, 2048, 4, 32, seed=0, device="cpu")
        nbr, wgt = gcn_adjacency(mine.edges, device="cpu")
        dense = np.zeros((512, 512), np.float32)
        np.add.at(dense, (np.arange(512)[:, None].repeat(nbr.shape[1], 1), nbr.numpy()),
                  wgt.numpy())
        np.testing.assert_allclose(dense, el.to_dense(), rtol=1e-6, atol=0)

    def test_init_follows_the_reference_distribution(self):
        cfg = gcn_cora.FULL
        model = GCN(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        w0 = model.weights[0]
        assert w0.shape == (1433, 16) and not w0.requires_grad
        assert abs(float(w0.std()) * 1433**0.5 - 1.0) < 0.05
        assert all(float(b.abs().max()) == 0.0 for b in model.biases)

    def test_needs_an_explicit_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GCN(gcn_cora.REDUCED)


def _reference_widedeep(seed=0):
    """``widedeep_init`` at REDUCED, with the zero-initialised wide table,
    dense weights and biases filled so that every term is exercised."""
    cfg = jax_wide_deep.REDUCED
    params = jax.tree.map(np.asarray, jax_recsys.widedeep_init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["wide_table"] = rng.normal(0, 0.1, params["wide_table"].shape).astype(np.float32)
    params["wide_dense"] = rng.normal(0, 0.1, params["wide_dense"].shape).astype(np.float32)
    params["bias"] = np.asarray(0.3, np.float32)
    params["mlp_b"] = [rng.normal(0, 0.1, b.shape).astype(np.float32) for b in params["mlp_b"]]
    return cfg, params


class TestWideDeep:
    @pytest.fixture
    def setup(self):
        cfg, params = _reference_widedeep()
        model = load_widedeep(WideDeep(wide_deep.REDUCED, device="cpu"), params)
        batch = sample_ctr_batch(CTRDataConfig(8, 4, 128, seed=0), 96)
        return cfg, params, model, batch

    def test_serve_matches_the_reference(self, setup):
        cfg, params, model, batch = setup
        want = np.asarray(
            jax_recsys.make_serve(cfg)(
                jax.tree.map(jnp.asarray, params),
                jnp.asarray(batch["sparse"]),
                jnp.asarray(batch["dense"]),
            )
        )
        before = launch_counts()
        got = make_serve(model)(batch["sparse"], batch["dense"])
        assert launch_counts() == before
        assert got.shape == (96,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)

    def test_retrieval_matches_the_reference(self, setup):
        cfg, params, model, batch = setup
        cand = np.random.default_rng(5).random((cells.pad512(1000), 16)).astype(np.float32)
        want = np.asarray(
            jax_recsys.make_retrieval_scorer(cfg)(
                jax.tree.map(jnp.asarray, params),
                jnp.asarray(batch["sparse"][:1]),
                jnp.asarray(batch["dense"][:1]),
                jnp.asarray(cand),
            )
        )
        got = make_retrieval_scorer(model)(
            batch["sparse"][:1], batch["dense"][:1], torch.from_numpy(cand)
        )
        assert got.shape == (1024,)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)

    def test_deep_lookup_is_bit_identical(self, setup):
        cfg, params, model, batch = setup
        rows = np.asarray(jax_recsys._offset_ids(cfg, jnp.asarray(batch["sparse"])))
        want = params["table"][rows].reshape(96, -1)
        got = model.embed(model.rows(batch["sparse"]))
        _same(got.numpy(), want)

    def test_plain_path_equals_kernel_path_on_the_cpu(self, setup):
        _, params, model, batch = setup
        plain = load_widedeep(WideDeep(wide_deep.REDUCED, device="cpu", use_kernel=False), params)
        assert torch.equal(
            model.serve(batch["sparse"], batch["dense"]),
            plain.serve(batch["sparse"], batch["dense"]),
        )

    @pytest.mark.parametrize("bad", [-1, 128, 10**6])
    def test_out_of_range_ids_raise_on_the_host(self, setup, bad):
        _, _, model, batch = setup
        ids = batch["sparse"].copy()
        ids[3, 5] = bad
        with pytest.raises(ValueError, match="sparse ids must lie in"):
            model.serve(ids, batch["dense"])

    def test_malformed_ids_raise(self, setup):
        _, _, model, batch = setup
        with pytest.raises(ValueError, match="must be"):
            model.rows(batch["sparse"][:, :5])
        with pytest.raises(TypeError):
            model.rows(batch["sparse"].astype(np.float32))

    def test_load_checks_shapes(self):
        _, params = _reference_widedeep()
        params["mlp_w"][0] = params["mlp_w"][0][:, :3]
        with pytest.raises(ValueError, match="mlp_w"):
            load_widedeep(WideDeep(wide_deep.REDUCED, device="cpu"), params)

    def test_init_follows_the_reference_distribution(self):
        model = WideDeep(wide_deep.REDUCED, generator=torch.Generator().manual_seed(2),
                         device="cpu")
        assert model.table.shape == (8 * 128, 8)
        assert abs(float(model.table.std()) / 0.02 - 1.0) < 0.05
        assert float(model.wide_table.abs().max()) == 0.0
        w0 = model.mlp_w[0]
        assert w0.shape == (8 * 8 + 4, 32)
        assert abs(float(w0.std()) * (68**0.5) - 1.0) < 0.1


class TestConfigs:
    def test_configs_are_the_reference_configs(self):
        for mine, ref in (
            (gcn_cora.FULL, jax_gcn_cora.FULL),
            (gcn_cora.REDUCED, jax_gcn_cora.REDUCED),
            (wide_deep.FULL, jax_wide_deep.FULL),
            (wide_deep.REDUCED, jax_wide_deep.REDUCED),
        ):
            a = dataclasses.asdict(mine)
            b = dataclasses.asdict(ref)
            a.pop("dtype")
            b.pop("dtype")
            assert a == b
        assert wide_deep.FULL.param_count() == jax_wide_deep.FULL.param_count()
        assert gcn_cora.SHAPES == jax_gcn_cora.SHAPES
        assert wide_deep.SHAPES == jax_wide_deep.SHAPES

    def test_shapes_are_the_reference_shapes(self):
        assert cells.GNN_SHAPES == jax_cells.GNN_SHAPES
        assert cells.RECSYS_SHAPES == jax_cells.RECSYS_SHAPES
        for x in (1, 512, 513, 1_000_000):
            assert cells.pad512(x) == jax_cells.pad512(x)
        cfg = cells.gcn_at_shape(gcn_cora.FULL, "ogb_products")
        assert (cfg.d_feat, cfg.d_hidden, cfg.n_classes) == (100, 16, 47)
