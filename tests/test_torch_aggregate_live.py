"""B4 ``csr_aggregate`` on live row lengths, and the GCN that passes them.

With ``live``, the CUDA kernel stops each row after its live slots and
then adds the slot at index ``live`` once with weight 0, so that a NaN or
Inf in the F row the pads name reaches the rows that have pads, as in
``repro``'s oracle (which sums every pad).  The kernel runs only on the
card (``test_torch_gpu.py``, ``chip_smoke.py``); here a plain emulation of
that schedule is held against ``repro``'s oracle and Pallas kernel, the
wrapper's CPU route against the plain version, the lane layout against
what the kernel's design states, and the GCN's live lengths and forward
against ``repro``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as jax_gcn_cora
from repro.core import symmetric_normalize
from repro.data.graphs import planted_partition_graph as jax_planted
from repro.graph.structures import EdgeList as JaxEdgeList
from repro.kernels.segment_reduce import csr_aggregate as jax_csr_aggregate
from repro.kernels.segment_reduce import csr_aggregate_ref as jax_csr_aggregate_ref
from repro.models import gnn as jax_gnn
from repro_torch.configs import gcn_cora
from repro_torch.data.graphs import planted_partition_graph
from repro_torch.kernels import launch_counts
from repro_torch.kernels.segment_reduce import (
    LiveRows,
    aggregate_lanes,
    csr_aggregate_op,
    csr_aggregate_ref,
    live_rows,
)
from repro_torch.models.convert import load_gcn
from repro_torch.models.gnn import GCN, gcn_adjacency, gcn_adjacency_live

F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol


def _schedule(nbr, wgt, lengths, F, pad=True):
    """The kernel's per-row sum in f32: slots ``0 .. live - 1`` in order,
    then, for a row with pads, ``0 · F[nbr[r, live]]`` once (left out with
    ``pad=False``)."""
    m, d = nbr.shape
    idx = nbr.long()
    lengths = lengths.long()
    acc = torch.zeros((m, F.shape[1]), dtype=torch.float32)
    for k in range(d):
        sel = k < lengths
        acc[sel] += wgt[sel, k, None].float() * F[idx[sel, k]].float()
    padded = (lengths < d) & pad
    pad_id = idx[torch.arange(m), lengths.clamp(max=d - 1)]
    acc[padded] += 0.0 * F[pad_id[padded]].float()
    return acc


def _padded_csr(m, n, d, s, seed, pad_id=0):
    """A padded CSR as PaddedCSR lays it out: live slots (nonzero weights)
    first, then pads of weight 0 naming ``pad_id``.  Row 0 is all pads and
    row 1 has none."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, d + 1, m)
    lengths[0], lengths[1] = 0, d
    nbr = rng.integers(0, n, (m, d)).astype(np.int32)
    wgt = (rng.random((m, d)) + 0.05).astype(np.float32)
    pad = np.arange(d)[None, :] >= lengths[:, None]
    nbr[pad], wgt[pad] = pad_id, 0.0
    F = rng.random((n, s)).astype(np.float32)
    return nbr, wgt, F


@pytest.mark.parametrize("m,n,d,s", [(64, 80, 12, 16), (33, 50, 89, 100), (40, 60, 7, 1)])
def test_schedule_matches_the_oracle_and_the_pallas_kernel(m, n, d, s):
    nbr, wgt, F = _padded_csr(m, n, d, s, seed=m + d)
    live = live_rows(wgt, "cpu")
    got = _schedule(torch.from_numpy(nbr), torch.from_numpy(wgt), live.lengths,
                    torch.from_numpy(F)).numpy()
    want = np.asarray(jax_csr_aggregate_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(F)))
    kern = np.asarray(jax_csr_aggregate(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(F),
                                        interpret=True))
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, kern, **F32_TOL)


@pytest.mark.parametrize("pad_id", [0, 5])
def test_schedule_puts_nan_in_the_rows_the_oracle_does(pad_id):
    """NaN and Inf behind the pads: the live schedule with its one pad slot
    matches the oracle's NaN rows; without the pad slot it does not."""
    nbr, wgt, F = _padded_csr(48, 70, 20, 16, seed=pad_id + 9, pad_id=pad_id)
    F[pad_id, 2] = np.nan
    F[pad_id, 9] = np.inf
    live = live_rows(wgt, "cpu")
    args = (torch.from_numpy(nbr), torch.from_numpy(wgt), live.lengths, torch.from_numpy(F))
    want = np.asarray(jax_csr_aggregate_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(F)))
    assert np.isnan(want[:, 2]).any() and np.isnan(want[:, 9]).any()
    got = _schedule(*args).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **F32_TOL)
    short = _schedule(*args, pad=False).numpy()
    assert not np.array_equal(np.isnan(short), np.isnan(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_given_live_is_the_plain_version_on_cpu(dtype):
    """On the CPU the wrapper takes the plain version, which sums every
    slot: with ``live`` it gives what it gives without, NaN included."""
    nbr, wgt, F = _padded_csr(40, 60, 16, 20, seed=3, pad_id=4)
    F[4, 7] = np.nan
    live = live_rows(wgt, "cpu")
    tn, tw, tF = torch.from_numpy(nbr), torch.from_numpy(wgt).to(dtype), torch.from_numpy(F).to(dtype)
    before = launch_counts()
    got = csr_aggregate_op(tn, tw, tF, live=live)
    assert launch_counts() == before
    want = csr_aggregate_ref(tn, tw, tF)
    assert got.dtype == dtype and torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize(
    "s,vec,lanes,live_lanes,rows_per_warp",
    [(100, 4, 32, 25, 1), (16, 4, 4, 4, 8), (1, 1, 1, 1, 32), (300, 4, 32, 32, 1), (2, 2, 1, 1, 32),
     (37, 1, 32, 32, 1), (20, 4, 8, 5, 4)],
)
def test_lanes_follow_the_row_width(s, vec, lanes, live_lanes, rows_per_warp):
    """One row group of ``lanes`` threads per row, VEC columns a lane; the
    GCN's S = 100 is one row a warp (25 live lanes), S = 16 eight rows."""
    got = aggregate_lanes(s, vec)
    assert got == lanes and 32 // got == rows_per_warp
    assert min(got, -(-s // vec)) == live_lanes


def _gnn_job_graph():
    """The 512-node graph and operator of ``repro.launch.train.build_gnn_job``."""
    cfg = jax_gcn_cora.REDUCED
    data = jax_planted(n_nodes=512, n_edges=2048, n_classes=cfg.n_classes,
                       d_feat=cfg.d_feat, seed=0)
    el = JaxEdgeList.from_dense(symmetric_normalize(data.edges.to_dense()))
    return data, el


def test_adjacency_lengths_are_the_live_rows_of_its_weights():
    """Every real edge of the normalised operator has a positive weight and
    the pads are (0, 0.0), so the in-degrees are the trailing-nonzero
    counts; the two-value builder returns the same table."""
    mine = planted_partition_graph(512, 2048, 4, 32, seed=0, device="cpu")
    nbr, wgt, live = gcn_adjacency_live(mine.edges, device="cpu")
    d = nbr.shape[1]
    slots = torch.arange(d)[None, :]
    real = slots < live.lengths[:, None].long()
    assert bool((wgt[real] > 0).all()) and bool((wgt[~real] == 0).all())
    assert bool((nbr[~real] == 0).all())
    want = live_rows(wgt.numpy(), "cpu")
    assert torch.equal(live.lengths, want.lengths) and live.slots == want.slots
    assert live.lengths.dtype == torch.int32 and int(live.lengths.max()) == d
    n2, w2 = gcn_adjacency(mine.edges, device="cpu")
    assert torch.equal(n2, nbr) and torch.equal(w2, wgt)


def test_reduced_forward_with_live_matches_the_reference():
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
    mine = planted_partition_graph(512, 2048, 4, 32, seed=0, device="cpu")
    nbr, wgt, live = gcn_adjacency_live(mine.edges, device="cpu")
    feats = torch.from_numpy(mine.feats)
    before = launch_counts()
    got = model(feats, nbr, wgt, live)
    assert launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert torch.equal(got, model(feats, nbr, wgt))


def test_forward_takes_live_rows_built_by_hand():
    data = planted_partition_graph(300, 1200, 5, 12, seed=3, device="cpu")
    nbr, wgt = gcn_adjacency(data.edges, device="cpu")
    live = live_rows(wgt.numpy(), "cpu")
    assert isinstance(live, LiveRows)
    cfg = dataclasses.replace(gcn_cora.REDUCED, d_feat=12, n_classes=5)
    model = GCN(cfg, device="cpu")
    feats = torch.from_numpy(data.feats)
    assert torch.equal(model(feats, nbr, wgt, live), model(feats, nbr, wgt))
