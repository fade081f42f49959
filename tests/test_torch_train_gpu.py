"""B4's backward and the GCN / SAGE train steps on the card (marker
``gpu``; skipped without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

``CSRAggregate``'s backward launches ``csr_aggregate`` on the transposed
padded CSR (``transpose_padded_csr``, built on the card): held to the
plain version on the same transpose at the f32 tolerance of
``tests/test_kernels.py::_tol``, with live lengths, and the gate must
reject the planted faults (every row one live slot short; the pad slot
left out while the F row the pads name holds NaN).  The GCN and SAGE
train cells' loss and every gradient on the kernel route (B4 forward and
backward) equal the plain route's at the same tolerance, with one
backward launch a GCN step and two a SAGE step.  The CPU route is held
to the JAX reference by ``test_torch_csr_aggregate_grad.py`` and
``test_torch_train.py``.
"""

import pytest
import torch

from repro_torch.configs import cells, gat_cora, gcn_cora
from repro_torch.graph.segment import gcn_norm
from repro_torch.kernels import launch_counts
from repro_torch.kernels.segment_reduce import (
    CSRAggregate,
    LiveRows,
    csr_aggregate_op,
    csr_aggregate_ref,
)
from repro_torch.models import gnn
from repro_torch.optim import tree_leaves, value_and_grad

pytestmark = pytest.mark.gpu

F32_TOL = dict(rtol=2e-4, atol=5e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _agrees(got, want):
    both = torch.isfinite(got) & torch.isfinite(want)
    return torch.equal(torch.isnan(got), torch.isnan(want)) and bool(
        torch.allclose(got[both], want[both], **F32_TOL))


def _operator(dev, n, e, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
    w = gcn_norm(src, dst, torch.ones(e, device=dev), n)
    return gnn.csr_operator(src, dst, w, n)


@pytest.mark.parametrize("n,e,s", [(5_000, 60_000, 16), (3_000, 40_000, 100), (700, 9_000, 3)])
def test_backward_on_the_transpose_matches_the_plain_version(dev, n, e, s):
    op = _operator(dev, n, e, seed=n)
    t = op.transpose
    G = torch.randn((n, s), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    before = launch_counts()["csr_aggregate_backward"]
    F = torch.randn((n, s), device=dev, requires_grad=True)
    out = CSRAggregate.apply(F, op.nbr, op.wgt, op.live, t)
    out.backward(G)
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate_backward"] == before + 1
    want = csr_aggregate_ref(t.nbr, t.wgt, G)
    assert _agrees(F.grad, want)
    assert _agrees(csr_aggregate_ref(op.nbr, op.wgt, F.detach()), out.detach())


def test_transpose_gate_rejects_the_planted_faults(dev):
    op = _operator(dev, 4_000, 50_000, seed=7)
    t = op.transpose
    G = torch.randn((4_000, 16), device=dev)
    short = LiveRows((t.live.lengths - 1).clamp_min(0), 0)
    assert not _agrees(csr_aggregate_op(t.nbr, t.wgt, G, live=short),
                       csr_aggregate_ref(t.nbr, t.wgt, G))
    d = t.nbr.shape[1]
    r = int(torch.nonzero(t.live.lengths < d)[0, 0])
    pad_id = int(t.nbr[r, int(t.live.lengths[r])])
    G[pad_id] = float("nan")
    want = csr_aggregate_ref(t.nbr, t.wgt, G)
    assert _agrees(csr_aggregate_op(t.nbr, t.wgt, G, live=t.live), want)
    pads = torch.arange(d, device=dev)[None, :] >= t.live.lengths[:, None]
    elsewhere = torch.where(pads, (pad_id + 1) % G.shape[0], t.nbr)
    assert not _agrees(csr_aggregate_op(elsewhere, t.wgt, G, live=t.live), want)


def _batch(dev, cell, n_classes, seed=0):
    specs = cell.input_specs[2]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {k: torch.randn(s.shape, generator=gen, device=dev)
           for k, s in specs.items() if s.dtype == torch.float32}
    n = next(iter(specs.values())).shape[0]
    if "src" in specs:
        e = specs["src"].shape[0]
        out["src"] = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
        out["dst"] = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
        out["w"] = gcn_norm(out["src"], out["dst"], torch.ones(e, device=dev), n)
        out["label_mask"] = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    else:
        b, f1 = specs["h0_n"].shape
        perm = torch.randperm(n, generator=gen, device=dev).int()
        out["h0_f"], out["h1_f"] = perm[:b].contiguous(), perm[b: b + b * f1].contiguous()
        for k in ("h0", "h1"):
            shp = specs[f"{k}_n"].shape
            out[f"{k}_n"] = torch.randint(0, n, shp, generator=gen, device=dev, dtype=torch.int32)
            out[f"{k}_m"] = torch.rand(shp, generator=gen, device=dev) < 0.9
    out["labels"] = torch.randint(0, n_classes, specs["labels"].shape, generator=gen,
                                  device=dev, dtype=torch.int32)
    return out


@pytest.mark.parametrize("arch,shape,backward", [
    ("gcn-cora", "full_graph_sm", 1), ("gcn-cora", "minibatch_lg", 2),
    ("gat-cora", "minibatch_lg", 2)])
def test_train_step_kernel_route_matches_the_plain_route(dev, monkeypatch, arch, shape, backward):
    if shape == "minibatch_lg":  # the sampled cell at a tenth of its seeds
        sh = dict(cells.GNN_SHAPES[shape], batch_nodes=128)
        monkeypatch.setitem(cells.GNN_SHAPES, shape, sh)
    cfg0 = gcn_cora.FULL if arch == "gcn-cora" else gat_cora.FULL
    cell = cells.gnn_cell(arch, cfg0, shape)
    plain = cells.gnn_cell(arch, cfg0, shape, use_kernel=False)
    batch = _batch(dev, cell, cells.GNN_SHAPES[shape]["n_classes"])
    params, state = cell.step_fn.init(torch.Generator(device=dev).manual_seed(0), dev)
    before = launch_counts()
    loss, grads = value_and_grad(cell.step_fn.loss_fn, params, batch)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["csr_aggregate"] - before["csr_aggregate"] == 2
    assert after["csr_aggregate_backward"] - before["csr_aggregate_backward"] == backward
    p_loss, p_grads = value_and_grad(plain.step_fn.loss_fn, params, batch)
    assert launch_counts() == after  # the plain route launches nothing
    torch.testing.assert_close(loss, p_loss, **F32_TOL)
    for a, b in zip(tree_leaves(grads), tree_leaves(p_grads)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, **F32_TOL)
    losses = []
    for _ in range(5):
        params, state, l = cell.step_fn(params, state, batch)
        losses.append(float(l))
    assert losses[-1] < losses[0]
