"""The port's GAT, DimeNet, MeshGraphNet and SAGE vs the JAX reference, on
the CPU.

Each model at its REDUCED config, with ``repro``'s parameters carried
across by ``repro_torch.models.convert``, must give ``repro``'s outputs at
``rtol=1e-4, atol=1e-5`` on the same inputs (made with numpy from a
seed); SAGE on both of its routes (``use_kernel``: the ``csr_aggregate``
wrapper, here its plain version; and the plain version itself).  The
card's runs are in ``test_torch_zoo_gpu.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as jax_dimenet
from repro.configs import gat_cora as jax_gat_cora
from repro.configs import gcn_cora as jax_gcn_cora
from repro.configs import meshgraphnet as jax_mgn
from repro.data.graphs import mesh_rollout_batch, molecule_batch
from repro.graph.sampler import CSRAdjacency, NeighborSampler, relabel_to_local
from repro.graph.structures import erdos_renyi
from repro.models import gnn as jax_gnn
from repro_torch.configs import dimenet, gat_cora, gcn_cora, meshgraphnet
from repro_torch.kernels import launch_counts
from repro_torch.models import gnn
from repro_torch.models.convert import load_dimenet, load_gat, load_mgn, load_sage

TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_cfg(cls, ref, **over):
    fields = dataclasses.asdict(ref)
    fields.pop("dtype")
    fields.update(over)
    return cls(**fields)


class TestGAT:
    @pytest.fixture(scope="class")
    def graph(self):
        g = erdos_renyi(96, 700, seed=3)
        feats = np.random.default_rng(0).normal(0, 1, (96, 32)).astype(np.float32)
        return g, feats

    @pytest.mark.parametrize("edge_chunk", [gnn.GAT_EDGE_CHUNK, 37, 1])
    def test_reduced_logits_match_the_reference(self, graph, edge_chunk, monkeypatch):
        g, feats = graph
        jcfg = jax_gat_cora.REDUCED
        params = jax_gnn.gat_init(jcfg, KEY)
        want = np.asarray(jax_gnn.gat_forward(jcfg, params, jnp.asarray(feats),
                                              jnp.asarray(g.src), jnp.asarray(g.dst), 96))
        monkeypatch.setattr(gnn, "GAT_EDGE_CHUNK", edge_chunk)
        model = load_gat(gnn.GAT(gat_cora.REDUCED, device="cpu"), _np(params))
        before = launch_counts()
        got = model(_t(feats), _t(g.src), _t(g.dst))
        assert launch_counts() == before
        assert got.shape == want.shape == (96, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_isolated_nodes_and_explicit_node_count(self, graph):
        """Nodes past the last edge get zero messages, as in ``segment_sum``."""
        g, feats = graph
        jcfg = dataclasses.replace(jax_gat_cora.REDUCED, n_layers=3)
        params = jax_gnn.gat_init(jcfg, KEY)
        big = np.concatenate([feats, np.ones((10, 32), np.float32)])
        want = np.asarray(jax_gnn.gat_forward(jcfg, params, jnp.asarray(big),
                                              jnp.asarray(g.src), jnp.asarray(g.dst), 106))
        model = load_gat(gnn.GAT(_port_cfg(gnn.GATConfig, jcfg), device="cpu"), _np(params))
        got = model(_t(big), _t(g.src), _t(g.dst), num_nodes=106)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_full_config_layer_shapes(self):
        model = gnn.GAT(gat_cora.FULL, device="cpu")
        params = jax.eval_shape(lambda k: jax_gnn.gat_init(jax_gat_cora.FULL, k), KEY)
        for lp, ref in zip(model.layers, params["layers"]):
            for name in ("w", "a_src", "a_dst"):
                assert tuple(lp[name].shape) == ref[name].shape
        # the reference draws a_src and a_dst from one key
        assert all(torch.equal(lp["a_src"], lp["a_dst"]) for lp in model.layers)


class TestDimeNet:
    @pytest.mark.parametrize("cap_factor", [None, 4])
    def test_reduced_energies_match_the_reference(self, cap_factor):
        b = molecule_batch(3, seed=1)
        n, e = b["z"].shape[0], b["src"].shape[0]
        cap = None if cap_factor is None else cap_factor * e
        kj, ji, mask = jax_gnn.build_triplets(b["src"], b["dst"], n, max_triplets=cap)
        jcfg = jax_dimenet.REDUCED
        params = jax_gnn.dimenet_init(jcfg, KEY)
        args = (b["z"], b["pos"], b["src"], b["dst"], kj, ji, mask, b["graph_ids"])
        want = np.asarray(jax_gnn.dimenet_forward(jcfg, params, *map(jnp.asarray, args), 3))
        model = load_dimenet(gnn.DimeNet(dimenet.REDUCED, device="cpu"), _np(params))
        got = model(*map(_t, args), 3)
        assert got.shape == want.shape == (3, 1)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # the mask as 0/1 floats, as the cell's input spec has it
        got_f = model(*map(_t, args[:6]), _t(mask.astype(np.float32)), _t(args[7]), 3)
        np.testing.assert_allclose(got_f.numpy(), want, **TOL)

    def test_bases_match_the_reference(self):
        rng = np.random.default_rng(2)
        d = np.concatenate([[0.0, 1e-7], rng.uniform(0.1, 6.0, 40)]).astype(np.float32)
        ang = rng.uniform(0, np.pi, d.shape[0]).astype(np.float32)
        np.testing.assert_allclose(gnn._rbf(_t(d), 6, 5.0).numpy(),
                                   np.asarray(jax_gnn._rbf(jnp.asarray(d), 6, 5.0)), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gnn._sbf(_t(d), _t(ang), 7, 6, 5.0).numpy(),
                                   np.asarray(jax_gnn._sbf(jnp.asarray(d), jnp.asarray(ang), 7, 6,
                                                           5.0)), rtol=1e-5, atol=1e-5)


class TestMeshGraphNet:
    @pytest.mark.parametrize("n,e", [(60, 200), (33, 0)])
    def test_reduced_outputs_match_the_reference(self, n, e):
        b = mesh_rollout_batch(n, e, seed=3)
        jcfg = jax_mgn.REDUCED
        params = jax_gnn.mgn_init(jcfg, KEY)
        args = (b["node_feat"], b["edge_feat"], b["src"], b["dst"])
        want = np.asarray(jax_gnn.mgn_forward(jcfg, params, *map(jnp.asarray, args), n))
        model = load_mgn(gnn.MeshGraphNet(meshgraphnet.REDUCED, device="cpu"), _np(params))
        got = model(*map(_t, args))
        assert got.shape == want.shape == (n, 3)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _sage_case(jcfg0, is_gat, seed=0):
    """A SAGE config derived as ``_spmm_family_cell`` derives it, and a
    sampled 2-hop batch of a random graph with some in-edgeless nodes."""
    g = erdos_renyi(300, 2500, seed=seed)
    keep = g.dst >= 6
    from repro.graph.structures import EdgeList

    g = EdgeList(g.src[keep], g.dst[keep], g.w[keep], 300)
    fanouts = (5, 3)
    d_hidden = max(jcfg0.d_hidden * (jcfg0.n_heads if is_gat else 1), 8)
    jcfg = jax_gnn.SageConfig(name=jcfg0.name, d_feat=24, d_hidden=d_hidden, n_classes=6,
                              fanouts=fanouts)
    seeds = np.random.default_rng(seed).choice(300, 32, replace=False)
    seeds[:3] = [0, 1, 2]
    subg = NeighborSampler(CSRAdjacency.from_edgelist(g), fanouts, seed=seed).sample(seeds)
    all_nodes, hops = relabel_to_local(subg)
    feats = np.random.default_rng(seed + 1).normal(0, 1, (all_nodes.shape[0], 24))
    return jcfg, feats.astype(np.float32), hops


class TestSAGE:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("arch", ["gat-cora", "gcn-cora"])
    def test_logits_match_the_reference(self, arch, use_kernel):
        ref0 = jax_gat_cora.REDUCED if arch == "gat-cora" else jax_gcn_cora.REDUCED
        jcfg, feats, hops = _sage_case(ref0, arch == "gat-cora")
        params = jax_gnn.sage_init(jcfg, KEY)
        jhops = [tuple(jnp.asarray(x) for x in h) for h in hops]
        want = np.asarray(jax_gnn.sage_block_forward(jcfg, params, jnp.asarray(feats), jhops))
        model = load_sage(gnn.SAGE(_port_cfg(gnn.SageConfig, jcfg), device="cpu",
                                   use_kernel=use_kernel), _np(params))
        before = launch_counts()
        got = model(_t(feats), [tuple(_t(x) for x in h) for h in hops])
        assert launch_counts() == before  # CPU tensors: the plain version
        assert got.shape == want.shape == (32, 6)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_hops_reach_the_aggregate_as_padded_rows(self, monkeypatch):
        """Each hop is one ``csr_aggregate_op`` call on ``(nbr, mask / count)``."""
        jcfg, feats, hops = _sage_case(jax_gcn_cora.REDUCED, False, seed=4)
        model = gnn.SAGE(_port_cfg(gnn.SageConfig, jcfg), device="cpu")
        calls = []
        real = gnn.csr_aggregate_op

        def spy(nbr, wgt, F, **kw):
            calls.append((nbr.shape, nbr.dtype, wgt.clone(), F.shape))
            return real(nbr, wgt, F, **kw)

        monkeypatch.setattr(gnn, "csr_aggregate_op", spy)
        model(_t(feats), [tuple(_t(x) for x in h) for h in hops])
        assert [c[0] for c in calls] == [hops[1][1].shape, hops[0][1].shape]
        for (shape, dtype, wgt, fshape), (_, _, mask) in zip(calls, reversed(hops)):
            assert dtype == torch.int32 and fshape == (feats.shape[0], jcfg.d_hidden)
            m = mask.astype(np.float32)
            want = m / np.maximum(m.sum(axis=1, keepdims=True), np.float32(1.0))
            np.testing.assert_array_equal(wgt.numpy(), want)


class TestLoad:
    def test_loaders_check_shapes_and_keys(self):
        params = _np(jax_gnn.gat_init(jax_gat_cora.REDUCED, KEY))
        params["layers"][0]["w"] = params["layers"][0]["w"][:, :-1]
        with pytest.raises(ValueError, match="w"):
            load_gat(gnn.GAT(gat_cora.REDUCED, device="cpu"), params)
        params = _np(jax_gnn.mgn_init(jax_mgn.REDUCED, KEY))
        params["blocks"] = params["blocks"][:-1]
        with pytest.raises(ValueError, match="blocks"):
            load_mgn(gnn.MeshGraphNet(meshgraphnet.REDUCED, device="cpu"), params)
        params = _np(jax_gnn.dimenet_init(jax_dimenet.REDUCED, KEY))
        params["blocks"][0].pop("w_out")
        with pytest.raises(ValueError, match="keys"):
            load_dimenet(gnn.DimeNet(dimenet.REDUCED, device="cpu"), params)

    @pytest.mark.parametrize(
        "name", ["gat", "dimenet", "mgn", "sage"]
    )
    def test_init_has_the_reference_shapes(self, name):
        jcfg = {"gat": jax_gat_cora.FULL, "dimenet": jax_dimenet.FULL, "mgn": jax_mgn.FULL,
                "sage": jax_gnn.SageConfig("s", 602, 64, 41)}[name]
        init = {"gat": jax_gnn.gat_init, "dimenet": jax_gnn.dimenet_init,
                "mgn": jax_gnn.mgn_init, "sage": jax_gnn.sage_init}[name]
        shapes = jax.eval_shape(lambda k: init(jcfg, k), KEY)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        model = {"gat": lambda: gnn.GAT(gat_cora.FULL, device="cpu"),
                 "dimenet": lambda: gnn.DimeNet(dimenet.FULL, device="cpu"),
                 "mgn": lambda: gnn.MeshGraphNet(meshgraphnet.FULL, device="cpu"),
                 "sage": lambda: gnn.SAGE(gnn.SageConfig("s", 602, 64, 41), device="cpu")}[name]()
        load = {"gat": load_gat, "dimenet": load_dimenet, "mgn": load_mgn, "sage": load_sage}[name]
        load(model, zeros)  # raises on any shape or key the reference does not have
        assert all(not p.requires_grad for p in model.parameters())
        assert all(float(p.abs().max()) == 0.0 for p in model.parameters())
        n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert sum(p.numel() for p in model.parameters()) == n_ref

    def test_models_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (lambda: gnn.GAT(gat_cora.REDUCED), lambda: gnn.DimeNet(dimenet.REDUCED),
                     lambda: gnn.MeshGraphNet(meshgraphnet.REDUCED),
                     lambda: gnn.SAGE(gnn.SageConfig("s", 8, 8, 2))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
