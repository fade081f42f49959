"""The ``dhlp-bio`` step and the GNN zoo on the card (marker ``gpu``;
skipped without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_zoo_gpu.py

B3 (``csr_round``) through ``make_lp_step`` and B4 (``csr_aggregate``)
through SAGE are held to their plain versions on the same CUDA inputs at
the f32 tolerance of ``tests/test_kernels.py::_tol`` (bf16 at 2e-2); GAT,
DimeNet and MeshGraphNet on the card to the same module on the CPU.  The
plain versions are held to the JAX reference by the CPU tests
(``test_torch_configs.py``, ``test_torch_gnn_zoo.py``).
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import dhlp_bio, dimenet, gat_cora, meshgraphnet
from repro_torch.data.graphs import mesh_rollout_batch, molecule_batch
from repro_torch.graph.sampler import CSRAdjacency, NeighborSampler, relabel_to_local
from repro_torch.graph.segment import gcn_norm
from repro_torch.graph.structures import erdos_renyi, powerlaw_graph
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.segment_reduce import csr_round_op, csr_round_ref
from repro_torch.models import gnn

pytestmark = pytest.mark.gpu

F32_TOL = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def _lp_inputs(n, e, s, dev, dtype=torch.float32):
    g = powerlaw_graph(n, e, seed=0, device=dev)
    src, dst = (torch.from_numpy(a).to(dev) for a in (g.src, g.dst))
    w = 0.5 * gcn_norm(src, dst, torch.ones(e, device=dev), n)
    Y = torch.zeros((n, s), device=dev)
    Y[torch.arange(s), torch.arange(s)] = 1.0
    return src, dst, w.to(dtype), Y.to(dtype), Y.clone().to(dtype)


@pytest.mark.parametrize("n,e,s", [(600, 20_000, 64), (2_000, 50_000, 100), (300, 5_000, 3)])
def test_lp_step_launches_b3_and_matches_plain(dev, n, e, s, monkeypatch):
    args = _lp_inputs(n, e, s, dev)
    step = dhlp_bio.make_lp_step(dhlp_bio.FULL)
    plan = dhlp_bio.lp_plan(*args[:3], n)
    reset_launch_counts()
    got = step(*args)
    torch.cuda.synchronize()
    assert launch_counts()["csr_round"] == dhlp_bio.FULL.rounds_per_step * len(plan.buckets)
    _close(got, dhlp_bio.lp_step_plain(dhlp_bio.FULL, *args), F32_TOL)
    monkeypatch.setattr(dhlp_bio, "PLAIN_MESSAGE_BUDGET", 7 * e)  # 7 columns at a time
    _close(got, dhlp_bio.lp_step_plain(dhlp_bio.FULL, *args), F32_TOL)


def test_lp_step_bf16_matches_f32(dev):
    args = _lp_inputs(1_000, 30_000, 64, dev)
    want = dhlp_bio.make_lp_step(dhlp_bio.FULL)(*args)
    bf = [args[0], args[1]] + [x.to(torch.bfloat16) for x in args[2:]]
    got = dhlp_bio.make_lp_step(dhlp_bio.FULL)(*bf)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_lp_plan_buckets_match_plain(dev):
    src, dst, w, Y, _ = _lp_inputs(3_000, 80_000, 128, dev)
    plan = dhlp_bio.lp_plan(src, dst, w, 3_000)
    F = torch.rand((3_000, 128), device=dev, generator=torch.Generator(dev).manual_seed(0))
    for rows, nbr, wgt, live in plan.buckets:
        got = csr_round_op(nbr, wgt, F, Y[rows], c=0.25, live=live)
        _close(got, csr_round_ref(nbr, wgt, F, Y[rows], 0.25), F32_TOL)


def _sampled(dev, seed=0):
    g = erdos_renyi(5_000, 200_000, seed=seed, device=dev)
    sampler = NeighborSampler(CSRAdjacency.from_edgelist(g, device=dev), (15, 10), seed=seed)
    seeds = np.random.default_rng(seed).choice(5_000, 256, replace=False)
    all_nodes, hops = relabel_to_local(sampler.sample(seeds))
    feats = torch.randn((all_nodes.shape[0], 96), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    return feats, [tuple(torch.from_numpy(x).to(dev) for x in h) for h in hops]


@pytest.mark.parametrize("d_hidden", [64, 20])
def test_sage_launches_b4_per_hop_and_matches_plain(dev, d_hidden):
    feats, hops = _sampled(dev)
    cfg = gnn.SageConfig("sage", d_feat=96, d_hidden=d_hidden, n_classes=41)
    model = gnn.SAGE(cfg, device=dev)
    reset_launch_counts()
    got = model(feats, hops)
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate"] == 2
    model.use_kernel = False
    _close(got, model(feats, hops), F32_TOL)


def _on_both(model_cpu, dev, *args):
    """The same module and inputs on the CPU and on the card."""
    model_dev = copy.deepcopy(model_cpu).to(dev)
    want = model_cpu(*[a if not torch.is_tensor(a) else a.cpu() for a in args])
    got = model_dev(*[a if not torch.is_tensor(a) else a.to(dev) for a in args])
    return got, want


def test_gat_on_the_card_matches_the_cpu(dev, monkeypatch):
    g = erdos_renyi(3_072, 10_752, seed=0, device="cpu")
    monkeypatch.setattr(gnn, "GAT_EDGE_CHUNK", 4_000)  # three chunks
    model = gnn.GAT(gat_cora.FULL, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (3_072, 1_433)).astype(np.float32))
    got, want = _on_both(model, dev, feats, torch.from_numpy(g.src), torch.from_numpy(g.dst))
    _close(got, want, MODEL_TOL)


def test_dimenet_on_the_card_matches_the_cpu(dev):
    b = molecule_batch(16, seed=0)
    n, e = b["z"].shape[0], b["src"].shape[0]
    kj, ji, mask = gnn.build_triplets(b["src"], b["dst"], n, max_triplets=4 * e)
    model = gnn.DimeNet(dimenet.FULL, device="cpu")
    args = [torch.from_numpy(a) for a in (b["z"], b["pos"], b["src"], b["dst"], kj, ji, mask,
                                          b["graph_ids"])]
    got, want = _on_both(model, dev, *args, 16)
    _close(got, want, MODEL_TOL)


def test_mgn_on_the_card_matches_the_cpu(dev):
    b = mesh_rollout_batch(4_096, 16_384, seed=0)
    model = gnn.MeshGraphNet(meshgraphnet.FULL, device="cpu")
    args = [torch.from_numpy(b[k]) for k in ("node_feat", "edge_feat", "src", "dst")]
    got, want = _on_both(model, dev, *args)
    _close(got, want, MODEL_TOL)
