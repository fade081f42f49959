"""The blocked-CSR round kernels' slot schedule, checked on the CPU.

B1 ``csr_round_residual`` and B3 ``csr_round`` stop each row after its
live slots and then add the slot at index ``live`` once with weight 0, so
that a NaN or Inf in the F row the pads name still reaches the rows that
have pads.  The CUDA kernels run only on the card (``test_torch_gpu.py``,
``chip_smoke.py``); here a plain emulation of that schedule is held
against ``repro``'s oracles, the layouts' ``live`` arrays against the
weights they come from, and the wrappers' CPU route and the kernel build
key are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import (
    csr_round_ref as jax_csr_round_ref,
    csr_round_residual_ref as jax_csr_residual_ref,
)
from repro_torch.core.solver import LPConfig
from repro_torch.engine import make_engine
from repro_torch.kernels import common, launch_counts
from repro_torch.kernels.segment_reduce import (
    LiveRows,
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
    live_rows,
    ops,
    rows_per_block,
    vector_width,
)
from repro_torch.scenarios import generate

F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol


def _schedule(nbr, wgt, lengths, F, pad=True):
    """The kernels' per-row sum in f32: slots ``0 .. live - 1`` in order,
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


def _padded_bucket(m, n, d, s, seed, pad_id=0):
    """A bucket laid out as the engines lay theirs out: each row's live
    slots (nonzero weights) first, then pads of weight 0 naming ``pad_id``.
    Row 0 is all pads and row 1 has none."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, d + 1, m)
    lengths[0], lengths[1] = 0, d
    nbr = rng.integers(0, n, (m, d)).astype(np.int32)
    wgt = (rng.random((m, d)) + 0.05).astype(np.float32)
    pad = np.arange(d)[None, :] >= lengths[:, None]
    nbr[pad], wgt[pad] = pad_id, 0.0
    F = rng.random((n, s)).astype(np.float32)
    base = rng.random((m, s)).astype(np.float32)
    prev = rng.random((m, s)).astype(np.float32)
    return nbr, wgt, F, base, prev


def _trailing_nonzero(wgt):
    """One past each row's last nonzero weight, by a plain loop."""
    out = []
    for row in np.asarray(wgt):
        nz = np.flatnonzero(row)
        out.append(int(nz[-1]) + 1 if nz.size else 0)
    return np.array(out)


@pytest.fixture(scope="module")
def layouts():
    """The ``kernel`` engine's two layouts of ``powerlaw`` scale 0.25."""
    net = generate("powerlaw", scale=0.25, seed=0, cache=False).network
    cfg = LPConfig(alg="dhlp2", alpha=0.5, sigma=1e-4, seed_mode="fixed", autotune=False)
    plan, _, rank = make_engine("kernel", cfg, device="cpu").prepare(net).payload.plan
    legacy, _ = (
        make_engine("kernel", cfg, device="cpu", fused_superstep=False)
        .prepare(net)
        .payload.fused
    )
    return {
        "plan": [(nbr, wgt, live) for nbr, wgt, live in plan],
        "legacy": [(nbr, wgt, live) for _, nbr, wgt, live in legacy],
        "pad_id": {"plan": int(rank[0]), "legacy": 0},
        "num_nodes": net.num_nodes,
    }


@pytest.mark.parametrize("layout", ["plan", "legacy"])
def test_live_lengths_are_trailing_nonzero_counts(layouts, layout):
    pad_id = layouts["pad_id"][layout]
    padded_rows = 0
    for nbr, wgt, live in layouts[layout]:
        want = _trailing_nonzero(wgt.numpy())
        got = live.lengths.numpy()
        assert live.lengths.dtype == torch.int32 and got.shape == (nbr.shape[0],)
        np.testing.assert_array_equal(got, want)
        assert live.slots == int(want.sum())
        # the live slots are the nonzeros, and every pad names the pad id
        pads = np.arange(nbr.shape[1])[None, :] >= got[:, None]
        assert np.count_nonzero(wgt.numpy()) == live.slots
        assert (wgt.numpy()[pads] == 0).all() and (nbr.numpy()[pads] == pad_id).all()
        padded_rows += int((got < nbr.shape[1]).sum())
    assert padded_rows > 0


@pytest.mark.parametrize("layout", ["plan", "legacy"])
def test_schedule_on_the_engine_layouts_is_the_plain_round(layouts, layout):
    n = layouts["num_nodes"]
    rng = np.random.default_rng(1)
    F = torch.from_numpy(rng.random((n, 24)).astype(np.float32))
    for nbr, wgt, live in layouts[layout]:
        base = torch.from_numpy(rng.random((nbr.shape[0], 24)).astype(np.float32))
        got = 0.3 * base + _schedule(nbr, wgt, live.lengths, F)
        np.testing.assert_allclose(
            got.numpy(), csr_round_ref(nbr, wgt, F, base, 0.3).numpy(), **F32_TOL
        )


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (40, 60, 45, 37),  # D not a multiple of 32, odd S
        (33, 200, 64, 130),
        (9, 300, 200, 96),  # wider than six 32-slot loads
    ],
)
def test_schedule_matches_the_oracle(m, n, d, s):
    nbr, wgt, F, base, prev = _padded_bucket(m, n, d, s, seed=m + d + s)
    lengths = torch.from_numpy(_trailing_nonzero(wgt))
    acc = _schedule(torch.from_numpy(nbr), torch.from_numpy(wgt), lengths, torch.from_numpy(F))
    got = 0.25 * torch.from_numpy(base) + acc
    j = [jnp.asarray(a) for a in (nbr, wgt, F, base)]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_csr_round_ref(*j, 0.25)), **F32_TOL
    )
    want, wdelta = jax_csr_residual_ref(*j, jnp.asarray(prev), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    delta = (got - torch.from_numpy(prev)).abs().amax(dim=0)
    np.testing.assert_allclose(delta.numpy(), np.asarray(wdelta)[0], **F32_TOL)


@pytest.mark.parametrize("pad_id", [0, 7])
def test_schedule_puts_nan_in_the_rows_the_oracle_does(pad_id):
    m, n, d, s = 60, 80, 48, 16
    nbr, wgt, F, base, _ = _padded_bucket(m, n, d, s, seed=pad_id + 3, pad_id=pad_id)
    F[pad_id, 3] = np.nan
    F[pad_id, 10] = np.inf
    lengths = torch.from_numpy(_trailing_nonzero(wgt))
    acc = _schedule(torch.from_numpy(nbr), torch.from_numpy(wgt), lengths, torch.from_numpy(F))
    got = (0.25 * torch.from_numpy(base) + acc).numpy()
    want = np.asarray(jax_csr_round_ref(*(jnp.asarray(a) for a in (nbr, wgt, F, base)), 0.25))
    assert np.isnan(want[:, 3]).sum() > 1 and np.isnan(want[:, 10]).sum() > 1
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **F32_TOL)
    # without the pad slot, padded rows that do not name the pad id lose it
    no_pad = _schedule(
        torch.from_numpy(nbr), torch.from_numpy(wgt), lengths, torch.from_numpy(F), pad=False
    )
    assert not np.array_equal(np.isnan(no_pad.numpy()), np.isnan(want))


def test_plan_names_its_first_ids_most(layouts):
    """In the fused plan's permuted space, the number of rows naming an id
    never grows with the id: ``id < H`` picks the H most-named nodes."""
    n = layouts["num_nodes"]
    named = np.zeros(n, dtype=np.int64)
    for nbr, _, live in layouts["plan"]:
        lengths = live.lengths.numpy()
        for r, row in enumerate(nbr.numpy()):
            named[np.unique(row[: lengths[r]])] += 1
    assert named[0] > named[-1]
    assert (np.diff(named) <= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["csr_round", "csr_round_residual"])
def test_wrappers_given_live_are_the_plain_version_on_cpu(kernel, dtype):
    nbr, wgt, F, base, prev = _padded_bucket(30, 50, 40, 20, seed=8)
    live = live_rows(wgt, "cpu")
    tn = torch.from_numpy(nbr)
    tw, tF = torch.from_numpy(wgt).to(dtype), torch.from_numpy(F).to(dtype)
    tb, tp = torch.from_numpy(base), torch.from_numpy(prev)
    before = launch_counts()
    if kernel == "csr_round":
        want = csr_round_ref(tn, tw, tF, tb, 0.3)
        got = csr_round_op(tn, tw, tF, tb, c=0.3, live=live)
        assert torch.equal(got, want)
    else:
        want, wdelta = csr_round_residual_ref(tn, tw, tF, tb, tp, 0.3)
        buf = torch.full((30, 20), float("nan"))
        got, delta = csr_round_residual_op(tn, tw, tF, tb, tp, c=0.3, live=live, out=buf)
        assert got is buf and torch.equal(got, want) and torch.equal(delta, wdelta)
    assert launch_counts() == before  # the plain version is no launch


def test_live_rows_counts_up_to_the_last_nonzero():
    wgt = np.array(
        [[0, 0, 0, 0], [1, 2, 3, 4], [1, 0, 2, 0], [0, 5, 0, 0]], dtype=np.float32
    )
    live = live_rows(wgt, "cpu")
    assert live.lengths.tolist() == [0, 4, 3, 2] and live.slots == 9
    assert isinstance(live, LiveRows)


def test_blocks_are_sized_by_live_slots():
    """A legacy-style bucket, 2,208 slots wide with ~300 live slots a row,
    gets the rows per block of its live width."""
    m, d = 64, 2208
    live = LiveRows(torch.full((m,), 300, dtype=torch.int32), 300 * m)
    assert ops._bucket_rows_per_block(m, d, live) == rows_per_block(300) == 6
    assert ops._bucket_rows_per_block(m, d, None) == rows_per_block(d) == 1


@pytest.mark.parametrize(
    "dtype,s,offset,want",
    [
        (torch.float32, 4396, 0, 4),  # the LP path: 16-byte lanes
        (torch.bfloat16, 4396, 0, 4),  # 8,792-byte rows: 8-byte lanes
        (torch.bfloat16, 4400, 0, 8),
        (torch.float32, 130, 0, 2),
        (torch.float32, 37, 0, 1),
        (torch.bfloat16, 37, 0, 1),
        (torch.float32, 128, 1, 1),  # F one element past an aligned address
        (torch.bfloat16, 128, 2, 2),
    ],
)
def test_vector_width_follows_row_length_and_alignment(dtype, s, offset, want):
    flat = torch.empty(4 * s + 64, dtype=dtype)
    skew = (-flat.data_ptr() % 16) // flat.element_size()  # 16-byte aligned start
    F = flat[skew + offset : skew + offset + 4 * s].view(4, s)
    assert vector_width(F) == want


def test_build_key_hashes_included_headers(tmp_path, monkeypatch):
    """Editing a ``csrc/`` header that a source includes (directly or
    through another header) changes the library's path, so a warm
    ``build/`` never serves a stale kernel."""
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("constexpr int kDepth = 4;\n")
    (tmp_path / "other.cu").write_text("int x;\n")
    monkeypatch.setattr(common, "CSRC_DIR", tmp_path)
    assert common._local_headers("k.cu") == ["inner.cuh", "outer.cuh"]
    first = common._target("k.cu")
    other = common._target("other.cu")
    (tmp_path / "inner.cuh").write_text("constexpr int kDepth = 8;\n")
    assert common._target("k.cu") != first
    assert common._target("other.cu") == other
    assert common._target("k.cu").name.startswith("k-")


def test_both_round_kernels_include_one_shared_inner_loop():
    for source in (ops.SOURCE, ops.ROUND_SOURCE):
        assert common._local_headers(source) == ["csr_round_common.cuh"]
