"""B4's gradient on the CPU route: ``CSRAggregate`` and the transposed CSR.

``CSRAggregate`` (forward ``A·F``, backward ``Aᵀ·∂out``, both through the
``csr_aggregate`` wrapper, here its plain version) passes
``torch.autograd.gradcheck`` in f64; ``transpose_padded_csr`` equals a
dense transpose (duplicate neighbours, pads, empty rows, a wider column
space); the GCN's loss gradient through the port's kernel route equals
``jax.grad`` of ``repro``'s COO ``gcn_forward`` at ``rtol=1e-4,
atol=1e-5``; and every kernel wrapper refuses inputs that require grad
while autograd records, on both routes (here the plain one).  On the card
the same gates run in ``test_torch_train_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as jax_gcn_cora
from repro.models import gnn as jax_gnn
from repro_torch.configs import gcn_cora
from repro_torch.kernels import (
    embedding_bag_op,
    gqa_attention_op,
    launch_counts,
    lp_round_op,
)
from repro_torch.kernels.segment_reduce import (
    CSRAggregate,
    csr_aggregate_op,
    csr_aggregate_ref,
    csr_round_op,
    csr_round_residual_op,
    transpose_padded_csr,
)
from repro_torch.models import gnn
from repro_torch.models.convert import load_gcn
from repro_torch.optim import value_and_grad

TOL = dict(rtol=1e-4, atol=1e-5)


def _csr(rng, m, n, d, dtype=torch.float64):
    """A padded CSR (m, d) over n columns: ragged live lengths, duplicate
    neighbours, an empty row, pads (0, 0) after the live slots."""
    nbr = rng.integers(0, n, (m, d)).astype(np.int32)
    nbr[m // 2, :3] = min(4, n - 1)  # duplicates
    wgt = rng.uniform(0.1, 1.0, (m, d))
    lengths = rng.integers(0, d + 1, m)
    lengths[-1] = 0
    for r, k in enumerate(lengths):
        nbr[r, k:] = 0
        wgt[r, k:] = 0.0
    return torch.from_numpy(nbr), torch.from_numpy(wgt).to(dtype)


def _dense(nbr, wgt, n):
    a = torch.zeros(nbr.shape[0], n, dtype=torch.float64)
    a.index_put_((torch.arange(nbr.shape[0])[:, None].expand_as(nbr), nbr.long()),
                  wgt.double(), accumulate=True)
    return a


@pytest.mark.parametrize("m,n,d", [(9, 7, 5), (6, 13, 4), (2, 3, 1)])
def test_transpose_is_the_dense_transpose(m, n, d):
    nbr, wgt = _csr(np.random.default_rng(m * n), m, n, d)
    t = transpose_padded_csr(nbr, wgt, n)
    assert t.nbr.shape[0] == n and t.nbr.dtype == torch.int32 and t.wgt.dtype == wgt.dtype
    torch.testing.assert_close(_dense(t.nbr, t.wgt, m), _dense(nbr, wgt, n).T)
    # live lengths: every slot before them nonzero, every slot after a pad
    lengths = t.live.lengths.long()
    slots = torch.arange(t.nbr.shape[1])[None, :]
    assert bool((t.wgt[slots < lengths[:, None]] != 0).all())
    assert bool((t.wgt[slots >= lengths[:, None]] == 0).all())
    assert bool((t.nbr[slots >= lengths[:, None]] == 0).all())
    assert t.live.slots == int(lengths.sum()) == int((wgt != 0).sum())


@pytest.mark.parametrize("s", [1, 3])
def test_gradcheck_f64(s):
    nbr, wgt = _csr(np.random.default_rng(s), 8, 6, 5)
    t = transpose_padded_csr(nbr, wgt, 6)
    F = torch.randn(6, s, dtype=torch.float64, generator=torch.Generator().manual_seed(s),
                    requires_grad=True)
    fn = lambda F: CSRAggregate.apply(F, nbr, wgt, None, t)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (F,))
    torch.testing.assert_close(fn(F), csr_aggregate_ref(nbr, wgt, F.detach()))


def test_operator_takes_no_gradient_and_no_launch_is_counted_on_the_cpu():
    nbr, wgt = _csr(np.random.default_rng(0), 5, 5, 3, torch.float32)
    t = transpose_padded_csr(nbr, wgt, 5)
    before = launch_counts()
    F = torch.randn(5, 2, requires_grad=True)
    CSRAggregate.apply(F, nbr, wgt, None, t).sum().backward()
    assert F.grad is not None and launch_counts() == before  # the plain route
    with pytest.raises(ValueError, match="operator"):
        CSRAggregate.apply(F, nbr, wgt.clone().requires_grad_(True), None, t)
    with pytest.raises(ValueError, match="transpose"):
        gnn._aggregate(nbr, wgt, F)


def test_gcn_gradient_matches_jax_grad_of_the_coo_reference():
    rng = np.random.default_rng(5)
    n, e = 40, 160
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    feats = rng.normal(0, 1, (n, 32)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    jcfg = jax_gcn_cora.REDUCED
    params = jax_gnn.gcn_init(jcfg, jax.random.PRNGKey(0))

    def jloss(p):
        logits = jax_gnn.gcn_forward(jcfg, p, *map(jnp.asarray, (feats, src, dst, w)), n)
        return jnp.mean(jax.nn.logsumexp(logits, -1) - logits[jnp.arange(n), labels])

    jl, jg = jax.value_and_grad(jloss)(params)
    model = load_gcn(gnn.GCN(gcn_cora.REDUCED, device="cpu"), jax.tree.map(np.asarray, params))
    op = gnn.csr_operator(*map(torch.from_numpy, (src, dst, w)), n)
    x, y = torch.from_numpy(feats), torch.from_numpy(labels).long()

    def loss(p, _):
        logits = gnn.gcn_forward_csr(p, x, op.nbr, op.wgt, op.live, op.transpose)
        return torch.mean(torch.logsumexp(logits, -1) - logits[torch.arange(n), y])

    tl, tg = value_and_grad(loss, model.param_tree(), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for a, b in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _wrapper_calls():
    nbr = torch.zeros(3, 2, dtype=torch.int32)
    wgt, F, base = torch.ones(3, 2), torch.ones(3, 4), torch.ones(3, 4)
    q = torch.ones(1, 4, 2, 16)
    return {
        "csr_aggregate": lambda g: csr_aggregate_op(nbr, wgt, F.requires_grad_(g)),
        "csr_round": lambda g: csr_round_op(nbr, wgt, F.requires_grad_(g), base, c=0.5),
        "csr_round_residual": lambda g: csr_round_residual_op(
            nbr, wgt, F.requires_grad_(g), base, base, c=0.5),
        "lp_round": lambda g: lp_round_op(torch.ones(3, 3).requires_grad_(g), F, base, c=0.5),
        "embedding_bag": lambda g: embedding_bag_op(
            torch.ones(5, 4).requires_grad_(g), torch.zeros(2, 3, dtype=torch.int32),
            torch.ones(2, 3)),
        "flash_attention": lambda g: gqa_attention_op(q.clone().requires_grad_(g), q, q,
                                                      layout="blhd"),
    }


@pytest.mark.parametrize("kernel", list(_wrapper_calls()))
def test_wrappers_refuse_inputs_that_require_grad(kernel):
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}: an input requires grad"):
        call(True)
    with torch.no_grad():
        call(True)  # nothing records: allowed
    call(False)
