"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs at the tolerances of ``tests/test_kernels.py::_tol``, B6 in bf16
at one ulp (``_flash_tol``; the plain versions are held against the JAX
reference by the CPU tests), and the
engines that launch them against the torch-op engines.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import h2o_danube_1_8b, stablelm_1_6b, wide_deep
from repro_torch.core.solver import HeteroLP, LPConfig
from repro_torch.data.graphs import planted_partition_graph
from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
from repro_torch.engine import make_engine
from repro_torch.kernels import launch_counts
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref
from repro_torch.kernels.flash_attention import (
    DECODE_ROWS,
    gqa_attention_op,
    gqa_attention_ref,
    regime,
)
from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
from repro_torch.kernels.segment_reduce import (
    csr_aggregate_op,
    csr_aggregate_ref,
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
    live_rows,
    vector_width,
)
from repro_torch.models.gnn import GCN, GCNConfig, gcn_adjacency, gcn_adjacency_live
from repro_torch.models.recsys import WideDeep
from repro_torch.models.transformer import Transformer, init_cache
from repro_torch.scenarios import generate

pytestmark = pytest.mark.gpu

STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=2e-4, atol=5e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), **tol
    )


def _csr_inputs(m, n, d, s, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    nbr = torch.from_numpy(rng.integers(0, n, (m, d)).astype(np.int32)).to(dev)
    wgt = (rng.random((m, d)) * (rng.random((m, d)) < 0.7)).astype(np.float32)
    F = rng.random((n, s)).astype(np.float32)
    base, prev = (rng.random((m, s)).astype(np.float32) for _ in range(2))
    cast = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    sdt = STORAGE[dtype]
    return nbr, cast(wgt, sdt), cast(F, sdt), cast(base, torch.float32), cast(
        prev, torch.float32
    )


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (128, 128, 8, 32),
        (200, 150, 11, 37),
        (64, 300, 33, 16),
        (17, 4396, 2208, 300),  # the widest main-path bucket width
        (1000, 5000, 136, 129),  # the narrowest, ragged columns
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_round_residual_kernel_matches_plain(dev, m, n, d, s, dtype):
    args = _csr_inputs(m, n, d, s, dtype, dev, seed=m + d)
    before = launch_counts()["csr_round_residual"]
    out, delta = csr_round_residual_op(*args, c=0.25)
    torch.cuda.synchronize()
    assert launch_counts()["csr_round_residual"] == before + 1
    want, wdelta = csr_round_residual_ref(*args, 0.25)
    assert out.dtype == torch.float32 and out.shape == (m, s)
    _close(out, want, _tol(dtype))
    _close(delta.amax(dim=0, keepdim=True), wdelta, _tol(dtype))
    again, adelta = csr_round_residual_op(*args, c=0.25)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(delta, adelta)


def test_csr_round_residual_writes_into_out_slice(dev):
    nbr, wgt, F, base, prev = _csr_inputs(40, 90, 16, 50, "f32", dev, seed=1)
    buf = torch.full((100, 50), float("nan"), device=dev)
    got, _ = csr_round_residual_op(nbr, wgt, F, base, prev, c=0.3, out=buf[30:70])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[30:70].data_ptr()
    _close(buf[30:70], csr_round_residual_ref(nbr, wgt, F, base, prev, 0.3)[0], _tol("f32"))
    assert torch.isnan(buf[:30]).all() and torch.isnan(buf[70:]).all()


def test_csr_round_residual_rejects_what_it_cannot_take(dev):
    nbr, wgt, F, base, prev = _csr_inputs(8, 20, 8, 12, "f32", dev, seed=2)
    with pytest.raises(TypeError):
        csr_round_residual_op(nbr, wgt.to(torch.bfloat16), F, base, prev, c=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        csr_round_residual_op(nbr, wgt, F.t().contiguous().t(), base, prev, c=0.1)
    with pytest.raises(ValueError, match="is on"):
        csr_round_residual_op(nbr, wgt, F, base.cpu(), prev, c=0.1)


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (128, 128, 8, 32),
        (200, 150, 11, 37),
        (64, 300, 130, 16),  # wider than one staged slab
        (64, 4396, 2208, 300),  # the widest legacy-path bucket width
        (1000, 5000, 392, 129),  # the narrowest, ragged columns
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_round_kernel_matches_plain(dev, m, n, d, s, dtype):
    nbr, wgt, F, base, _ = _csr_inputs(m, n, d, s, dtype, dev, seed=m + d + 1)
    before = launch_counts()["csr_round"]
    out = csr_round_op(nbr, wgt, F, base, c=0.25)
    torch.cuda.synchronize()
    assert launch_counts()["csr_round"] == before + 1
    assert out.dtype == STORAGE[dtype] and out.shape == (m, s)
    _close(out, csr_round_ref(nbr, wgt, F, base, 0.25), _tol(dtype))
    again = csr_round_op(nbr, wgt, F, base, c=0.25)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no atomics: byte-identical launches


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_round_writes_into_out_slice(dev, dtype):
    nbr, wgt, F, base, _ = _csr_inputs(40, 90, 16, 50, dtype, dev, seed=3)
    buf = torch.full((100, 50), float("nan"), device=dev, dtype=STORAGE[dtype])
    got = csr_round_op(nbr, wgt, F, base, c=0.3, out=buf[30:70])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[30:70].data_ptr()
    _close(buf[30:70], csr_round_ref(nbr, wgt, F, base, 0.3), _tol(dtype))
    assert torch.isnan(buf[:30].float()).all() and torch.isnan(buf[70:].float()).all()


def test_csr_round_rejects_what_it_cannot_take(dev):
    nbr, wgt, F, base, _ = _csr_inputs(8, 20, 8, 12, "f32", dev, seed=4)
    before = launch_counts()["csr_round"]
    with pytest.raises(TypeError):  # weights and panel of different dtypes
        csr_round_op(nbr, wgt.to(torch.bfloat16), F, base, c=0.1)
    with pytest.raises(TypeError):  # base must be f32
        csr_round_op(nbr, wgt, F, base.to(torch.bfloat16), c=0.1)
    with pytest.raises(TypeError):  # out takes F's dtype
        csr_round_op(nbr, wgt, F, base, c=0.1, out=torch.empty(8, 12, device=dev).half())
    with pytest.raises(TypeError):  # int32 neighbour ids
        csr_round_op(nbr.long(), wgt, F, base, c=0.1)
    with pytest.raises(ValueError, match="shape"):
        csr_round_op(nbr, wgt, F, base[:5], c=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        csr_round_op(nbr, wgt, F.t().contiguous().t(), base, c=0.1)
    with pytest.raises(ValueError, match="is on"):
        csr_round_op(nbr, wgt, F, base.cpu(), c=0.1)
    assert launch_counts()["csr_round"] == before


def _padded_bucket(m, n, d, s, dtype, dev, seed, pad_id=0):
    """A bucket laid out as the engines lay theirs out: every row's live
    slots first (nonzero weights), then pads of weight 0 naming ``pad_id``.
    Row 0 is all pads, row 1 has no pad, the rest are ragged."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, d + 1, m)
    lengths[0], lengths[1 % m] = 0, d
    nbr = rng.integers(0, n, (m, d)).astype(np.int32)
    wgt = (rng.random((m, d)) + 0.05).astype(np.float32)
    pad = np.arange(d)[None, :] >= lengths[:, None]
    nbr[pad], wgt[pad] = pad_id, 0.0
    F = rng.random((n, s)).astype(np.float32)
    base, prev = (rng.random((m, s)).astype(np.float32) for _ in range(2))
    sdt = STORAGE[dtype]
    cast = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)  # noqa: E731
    return dict(
        nbr=cast(nbr, torch.int32),
        wgt=cast(wgt, sdt),
        F=cast(F, sdt),
        base=cast(base, torch.float32),
        prev=cast(prev, torch.float32),
        live=live_rows(wgt, dev),
    )


def _round(kernel, b, **kw):
    """B3 or B1 on a bucket from ``_padded_bucket``; B1 gives its delta too."""
    if kernel == "csr_round":
        args = (b["nbr"], b["wgt"], b["F"], b["base"])
        return csr_round_op(*args, c=0.3, **kw), csr_round_ref(*args, 0.3), None, None
    args = (b["nbr"], b["wgt"], b["F"], b["base"], b["prev"])
    out, delta = csr_round_residual_op(*args, c=0.3, **kw)
    want, wdelta = csr_round_residual_ref(*args, 0.3)
    return out, want, delta, wdelta


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (50, 70, 45, 37),  # D not a multiple of 32, odd S (one column a lane)
        (33, 200, 64, 130),  # S a multiple of 2, not of 4
        (70, 300, 200, 128),  # full 16-byte lanes
        (9, 400, 300, 4396),  # the LP path's S; fewer rows than a block has warps
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["csr_round", "csr_round_residual"])
def test_csr_round_kernels_stop_at_live_lengths(dev, kernel, m, n, d, s, dtype):
    b = _padded_bucket(m, n, d, s, dtype, dev, seed=m + d + s)
    assert int(b["live"].lengths[0]) == 0 and int(b["live"].lengths[1]) == d
    before = launch_counts()[kernel]
    out, want, delta, wdelta = _round(kernel, b, live=b["live"])
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == before + 1
    _close(out, want, _tol(dtype))
    if delta is not None:
        _close(delta.amax(dim=0, keepdim=True), wdelta, _tol(dtype))
    # skipping the pads changes nothing: the full-width launch agrees
    full, _, _, _ = _round(kernel, b)
    _close(out, full, _tol(dtype))
    again, _, adelta, _ = _round(kernel, b, live=b["live"])
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert delta is None or torch.equal(delta, adelta)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["csr_round", "csr_round_residual"])
def test_csr_round_kernels_take_unaligned_slices(dev, kernel, dtype):
    """F starting one element past a 16-byte boundary and ``out=`` row
    slices at odd offsets: the vector width falls back, the result holds."""
    m, n, d, s = 40, 90, 40, 132
    b = _padded_bucket(m, n, d, s, dtype, dev, seed=11)
    flat = torch.empty(n * s + 1, device=dev, dtype=STORAGE[dtype])
    shifted = flat[1:].view(n, s)
    shifted.copy_(b["F"])
    assert vector_width(b["F"]) == 4  # S = 132: 16 bytes in f32, 8 in bf16
    assert vector_width(shifted) == 1
    odt = STORAGE[dtype] if kernel == "csr_round" else torch.float32
    buf = torch.full((m + 7, s), float("nan"), device=dev, dtype=odt)
    b_shifted = dict(b, F=shifted)
    got, want, _, _ = _round(kernel, b_shifted, live=b["live"], out=buf[3 : 3 + m])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[3 : 3 + m].data_ptr()
    _close(buf[3 : 3 + m], want, _tol(dtype))
    assert torch.isnan(buf[:3].float()).all() and torch.isnan(buf[3 + m :].float()).all()


@pytest.mark.parametrize("pad_id", [0, 7])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["csr_round", "csr_round_residual"])
def test_csr_round_kernels_keep_nan_from_the_pad_row(dev, kernel, dtype, pad_id):
    """NaN and Inf in the F row that the pads name reach exactly the rows
    the plain version (which sums every pad) puts them in."""
    m, n, d, s = 60, 80, 48, 64
    b = _padded_bucket(m, n, d, s, dtype, dev, seed=pad_id + 5, pad_id=pad_id)
    b["F"][pad_id, 3] = float("nan")
    b["F"][pad_id, 10] = float("inf")
    out, want, _, _ = _round(kernel, b, live=b["live"])
    torch.cuda.synchronize()
    got, ref = out.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isnan(ref[:, 3]).any() and np.isnan(ref[:, 10]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, equal_nan=True, **_tol(dtype))


@pytest.mark.parametrize(
    "n,s", [(128, 128), (257, 130), (384, 96), (64, 640), (1000, 1111)]
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lp_round_kernel_matches_plain(dev, n, s, dtype):
    rng = np.random.default_rng(n + s)
    sdt = STORAGE[dtype]
    A = torch.from_numpy((rng.random((n, n)) / n).astype(np.float32)).to(dev, sdt)
    F, base = (
        torch.from_numpy(rng.random((n, s)).astype(np.float32)).to(dev, sdt)
        for _ in range(2)
    )
    before = launch_counts()["lp_round"]
    out = lp_round_op(A, F, base, c=0.36)
    torch.cuda.synchronize()
    assert launch_counts()["lp_round"] == before + 1
    assert out.dtype == sdt
    _close(out, lp_round_ref(A, F, base, 0.36), _tol(dtype))
    assert torch.equal(out, lp_round_op(A, F, base, c=0.36))


@pytest.fixture(scope="module")
def net():
    return generate("bio_tri", scale=0.25, seed=0, cache=False).network


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_kernel_engine_on_the_card(dev, net, storage):
    cfg = LPConfig(
        alg="dhlp2", sigma=1e-4, seed_mode="fixed", autotune=False,
        storage_dtype=storage,
    )
    before = launch_counts()["csr_round_residual"]
    got = make_engine("kernel", cfg, device=dev).run(net)
    assert launch_counts()["csr_round_residual"] > before
    for other in (
        make_engine("sparse", cfg, device=dev).run(net),
        make_engine("kernel", cfg, device="cpu").run(net),
    ):
        np.testing.assert_allclose(got.F, other.F, **_tol(storage))
        assert got.outer_iters == other.outer_iters


def test_dense_use_kernel_on_the_card(dev, net):
    cfg = LPConfig(backend="dense", use_kernel=True, sigma=1e-4, seed_mode="fixed")
    before = launch_counts()["lp_round"]
    got = HeteroLP(cfg, device=dev).run(net)
    assert launch_counts()["lp_round"] - before == got.outer_iters
    want = HeteroLP(cfg, device="cpu").run(net)
    np.testing.assert_allclose(got.F, want.F, **_tol("f32"))
    assert got.outer_iters == want.outer_iters


def test_legacy_kernel_engine_on_the_card(dev, net):
    """fused_superstep=False on ``kernel``: one csr_round launch per bucket
    and round, against the torch-op legacy loop and the CPU plain path."""
    cfg = LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed", autotune=False)
    engine = make_engine("kernel", cfg, device=dev, fused_superstep=False)
    op = engine.prepare(net)
    before = launch_counts()
    got = engine.solve(op, np.eye(net.num_nodes))
    after = launch_counts()
    n_buckets = len(op.payload.fused[0])
    assert after["csr_round"] - before["csr_round"] == n_buckets * got.outer_iters
    assert after["csr_round_residual"] == before["csr_round_residual"]
    for other in (
        make_engine("sparse", cfg, device=dev, fused_superstep=False).run(net),
        make_engine("kernel", cfg, device="cpu", fused_superstep=False).run(net),
    ):
        np.testing.assert_allclose(got.F, other.F, **_tol("f32"))
        assert got.outer_iters == other.outer_iters
        np.testing.assert_array_equal(got.per_column_iters, other.per_column_iters)


@pytest.mark.parametrize(
    "fused,storage", [(True, "f32"), (True, "bf16"), (False, "f32")]
)
def test_sparse_dhlp1_on_the_card(dev, net, fused, storage):
    cfg = LPConfig(alg="dhlp1", sigma=1e-4, autotune=False, storage_dtype=storage)
    before = launch_counts()
    got = make_engine("sparse", cfg, device=dev, fused_superstep=fused).run(net)
    assert launch_counts() == before  # sparse is the torch-op engine
    want = make_engine("sparse", cfg, device="cpu", fused_superstep=fused).run(net)
    np.testing.assert_allclose(got.F, want.F, **_tol(storage))
    assert got.outer_iters == want.outer_iters
    if storage == "f32":  # bf16 rounding may move an inner round by one
        assert got.inner_iters == want.inner_iters


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (128, 128, 8, 32),
        (200, 150, 11, 37),  # ragged on every axis, two columns per lane
        (256, 256, 33, 128),
        (1000, 5000, 89, 100),  # the GCN's first layer: D = 89, S = 100
        (1001, 5000, 89, 16),  # the second: two rows per warp
        (77, 300, 130, 1),  # one column: 32 rows per warp
        (50, 60, 5, 300),  # three column tiles, the last ragged
        (9, 30, 0, 20),  # no slots: zeros
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_aggregate_kernel_matches_plain(dev, m, n, d, s, dtype):
    nbr, wgt, F, _, _ = _csr_inputs(m, n, d, s, dtype, dev, seed=m + d + 2)
    before = launch_counts()["csr_aggregate"]
    out = csr_aggregate_op(nbr, wgt, F)
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate"] == before + 1
    assert out.dtype == STORAGE[dtype] and out.shape == (m, s)
    _close(out, csr_aggregate_ref(nbr, wgt, F), _tol(dtype))
    again = csr_aggregate_op(nbr, wgt, F)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no atomics: byte-identical launches


def test_csr_aggregate_sums_padding_slots_like_the_reference(dev):
    """Pads (node 0, weight 0) are summed, not skipped: a NaN in F[0]
    reaches every row with a pad, as in the plain version's einsum."""
    nbr, wgt, F, _, _ = _csr_inputs(64, 80, 12, 20, "f32", dev, seed=7)
    nbr[::2, -3:] = 0
    wgt[::2, -3:] = 0.0
    F[0, 5] = float("nan")
    got = csr_aggregate_op(nbr, wgt, F)
    want = csr_aggregate_ref(nbr, wgt, F)
    torch.cuda.synchronize()
    assert torch.isnan(got[::2, 5]).all()
    np.testing.assert_array_equal(torch.isnan(got).cpu().numpy(), torch.isnan(want).cpu().numpy())


def test_csr_aggregate_rejects_what_it_cannot_take(dev):
    nbr, wgt, F, _, _ = _csr_inputs(8, 20, 8, 12, "f32", dev, seed=4)
    before = launch_counts()["csr_aggregate"]
    with pytest.raises(TypeError):
        csr_aggregate_op(nbr, wgt.to(torch.bfloat16), F)
    with pytest.raises(TypeError):
        csr_aggregate_op(nbr.long(), wgt, F)
    with pytest.raises(TypeError):
        csr_aggregate_op(nbr, wgt, F, out=torch.empty(8, 12, device=dev).half())
    with pytest.raises(ValueError, match="contiguous"):
        csr_aggregate_op(nbr, wgt, F.t().contiguous().t())
    with pytest.raises(ValueError, match="is on"):
        csr_aggregate_op(nbr.cpu(), wgt, F)
    assert launch_counts()["csr_aggregate"] == before


def _bag_inputs(v, d, b, k, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    sdt = STORAGE[dtype]
    tab = torch.from_numpy(rng.random((v, d)).astype(np.float32)).to(dev, sdt)
    idx = torch.from_numpy(rng.integers(0, v, (b, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.random((b, k)).astype(np.float32)).to(dev, sdt)
    return tab, idx, w


@pytest.mark.parametrize(
    "v,d,b,k",
    [
        (1000, 32, 128, 5),
        (4096, 16, 300, 8),
        (512, 64, 64, 40),  # two columns per lane
        (1000, 32, 1001, 1),  # the deep lookup: one 128-byte row per bag
        (900, 1, 301, 40),  # the wide lookup: lanes over K
        (100, 3, 77, 7),  # lanes over K, three columns, ragged bags
        (100, 200, 33, 3),  # two column tiles
        (64, 8, 20, 0),  # empty bags: zeros
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_kernel_matches_plain(dev, v, d, b, k, dtype):
    tab, idx, w = _bag_inputs(v, d, b, k, dtype, dev, seed=v + d + k)
    before = launch_counts()["embedding_bag"]
    out = embedding_bag_op(tab, idx, w)
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] == before + 1
    assert out.dtype == STORAGE[dtype] and out.shape == (b, d)
    _close(out, embedding_bag_ref(tab, idx, w), _tol(dtype))
    assert torch.equal(out, embedding_bag_op(tab, idx, w))


def test_embedding_bag_one_slot_is_an_exact_gather(dev):
    tab, idx, _ = _bag_inputs(5000, 32, 4000, 1, "f32", dev, seed=1)
    got = embedding_bag_op(tab, idx, torch.ones(idx.shape, device=dev))
    assert torch.equal(got, tab[idx[:, 0].long()])


def test_embedding_bag_rejects_what_it_cannot_take(dev):
    tab, idx, w = _bag_inputs(50, 8, 10, 4, "f32", dev, seed=2)
    before = launch_counts()["embedding_bag"]
    with pytest.raises(TypeError):
        embedding_bag_op(tab, idx.long(), w)
    with pytest.raises(TypeError):
        embedding_bag_op(tab, idx, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        embedding_bag_op(tab, idx, w[:5])
    with pytest.raises(ValueError, match="is on"):
        embedding_bag_op(tab, idx, w.cpu())
    assert launch_counts()["embedding_bag"] == before


def test_gcn_on_the_card(dev):
    data = planted_partition_graph(3000, 20000, 7, 100, seed=0, device=dev)
    cfg = GCNConfig(name="gcn", d_feat=100, n_classes=7)
    gpu = GCN(cfg, device=dev)
    cpu = GCN(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    nbr, wgt = gcn_adjacency(data.edges, device=dev)
    before = launch_counts()["csr_aggregate"]
    got = gpu(torch.from_numpy(data.feats).to(dev), nbr, wgt)
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate"] - before == cfg.n_layers
    want = cpu(torch.from_numpy(data.feats), nbr.cpu(), wgt.cpu())
    _close(got, want, _tol("f32"))


def test_wide_deep_on_the_card(dev):
    cfg = wide_deep.REDUCED
    gpu = WideDeep(cfg, device=dev)
    with torch.no_grad():
        gpu.wide_table.normal_(0.0, 0.1)
        gpu.bias.fill_(0.3)
    cpu = WideDeep(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = sample_ctr_batch(CTRDataConfig(cfg.n_sparse, cfg.n_dense, cfg.vocab_per_field), 700)
    before = launch_counts()["embedding_bag"]
    got = gpu.serve(batch["sparse"], batch["dense"])
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] - before == 2
    _close(got, cpu.serve(batch["sparse"], batch["dense"]), _tol("f32"))
    cand = torch.rand((1024, cfg.mlp_dims[-1]))
    before = launch_counts()["embedding_bag"]
    got = gpu.retrieval_score(batch["sparse"][:1], batch["dense"][:1], cand.to(dev))
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] - before == 1
    _close(got, cpu.retrieval_score(batch["sparse"][:1], batch["dense"][:1], cand), _tol("f32"))


# --------------------------------------------------------------- B6 flash_attention
def _attn_inputs(b, hq, hkv, lq, lk, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    cast = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=STORAGE[dtype])
    return (cast(rng.standard_normal((b, hq, lq, d))), cast(rng.standard_normal((b, hkv, lk, d))),
            cast(rng.standard_normal((b, hkv, lk, d))))


def _flash_tol(name):
    """B6 vs its plain version: both score, softmax and sum in f32 and round
    only the output, so two bf16 outputs differ by at most one unit in the
    last place (2**-7 of the value); ``atol`` covers f32 summation order
    near zero only."""
    return dict(rtol=2e-2, atol=1e-5) if name == "bf16" else _tol(name)


@pytest.mark.parametrize(
    "b,hq,hkv,lq,lk,d,window,q_offset",
    [
        (2, 4, 4, 128, 128, 64, None, 0),  # tests/test_kernels.py::TestFlashAttention sweep
        (1, 2, 2, 100, 100, 32, 48, 0),
        (2, 2, 2, 1, 256, 64, None, 255),
        (1, 3, 3, 130, 200, 64, None, 70),
        (1, 1, 1, 64, 512, 128, 128, 448),
        (2, 4, 2, 96, 96, 16, 16, 0),  # danube REDUCED: GQA 4/2, D = 16, window 16
        (1, 8, 2, 300, 300, 80, 64, 0),  # danube's group of 4 and D = 80
        (3, 32, 8, 1, 700, 80, 512, 650),  # a danube decode step
        (2, 4, 1, 5, 40, 32, None, 35),  # 20 rows per KV head: the 64-row tile
        (1, 32, 1, 1, 100, 64, None, 99),  # one KV head for 32 query heads
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(dev, b, hq, hkv, lq, lk, d, window, q_offset, dtype):
    q, k, v = _attn_inputs(b, hq, hkv, lq, lk, d, dtype, dev, seed=lq + lk + d)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = launch_counts()["flash_attention"]
    got = gqa_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, gqa_attention_ref(q, k, v, **kw), _flash_tol(dtype))
    assert torch.equal(got, gqa_attention_op(q, k, v, **kw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_reads_the_cache_layout_in_place(dev, dtype):
    """Sequence-major q and (2, B, S, Hkv, D) cache slices, read through strides."""
    b, hq, hkv, s, lq, d = 3, 8, 2, 64, 7, 80
    q, _, _ = _attn_inputs(b, hq, hkv, lq, s, d, dtype, dev, seed=5)
    cache = torch.randn((2, b, s, hkv, d), device=dev).to(STORAGE[dtype])
    qs = q.transpose(1, 2)  # (B, Lq, Hq, D), not contiguous
    got = gqa_attention_op(qs, cache[0], cache[1], window=16, q_offset=40, layout="blhd")
    want = gqa_attention_ref(qs, cache[0], cache[1], window=16, q_offset=40, layout="blhd")
    _close(got, want, _flash_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_rows_without_keys_are_nan_like_the_plain_version(dev, dtype):
    """Both bf16 regimes too: 12 rows per KV head (decode), 24 (prefill)."""
    for hq in (2, 4):
        q, k, v = _attn_inputs(1, hq, 2, 6, 8, 32, dtype, dev, seed=3)
        for kw in (dict(window=2, q_offset=10), dict(q_offset=-2)):
            got = gqa_attention_op(q, k, v, **kw)
            want = gqa_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want).any()
            keep = ~torch.isnan(want)
            _close(got[keep], want[keep], _flash_tol(dtype))


@pytest.mark.parametrize(
    "b,hq,hkv,lq,lk,d,window,q_offset",
    [
        (2, 16, 4, 4, 300, 64, None, 296),  # 16 rows per KV head: the last decode size
        (1, 1, 1, 17, 17, 32, None, 0),  # 17: the smallest prefill
        (1, 8, 2, 16, 200, 80, 100, 184),  # 64: one full prefill tile
        (1, 5, 1, 13, 77, 16, None, 64),  # 65: a second tile with one row
        (2, 4, 4, 128, 128, 128, None, 0),  # 128: two full tiles
        (1, 3, 1, 43, 150, 64, 50, 107),  # 129, window edge inside key tiles
        (1, 2, 2, 100, 100, 32, 37, 0),  # window of 37 keys: both edges inside a tile
        (1, 4, 2, 40, 64, 64, None, -10),  # negative q_offset: rows before key 0 are NaN
        (3, 16, 4, 4, 90, 16, None, -3),  # decode rows before key 0
        (3, 8, 8, 1, 333, 16, None, 332),  # group = 1 decode step
        (3, 8, 8, 1, 333, 128, 200, 332),  # group = 1 decode, D = 128, windowed
        (2, 8, 2, 1, 4100, 80, 4096, 4099),  # danube decode: the ring over 33 stages
        (1, 8, 2, 600, 600, 80, 256, 0),  # danube prefill tiles past the window
        (1, 4, 1, 250, 1000, 32, None, 750),  # a chunk of a longer prompt
    ],
)
def test_flash_attention_bf16_tiles_at_their_edges(dev, b, hq, hkv, lq, lk, d, window, q_offset):
    """The tensor-core regimes at their tiles' edges: rows per (batch, KV
    head) of 16 / 17 / 64 / 65 / 128 / 129, Lk not a multiple of the key
    tile, every head dim, window edges inside a tile, negative q_offset."""
    q, k, v = _attn_inputs(b, hq, hkv, lq, lk, d, "bf16", dev, seed=lq + lk + d)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    rows = lq * (hq // hkv)
    assert regime(q.dtype, rows) == ("decode" if rows <= DECODE_ROWS else "prefill")
    before = launch_counts()["flash_attention"]
    got = gqa_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = gqa_attention_ref(q, k, v, **kw)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert (q_offset < 0) == bool(torch.isnan(want).any())
    _close(got, want, _flash_tol("bf16"))  # NaN where both are NaN
    again = gqa_attention_op(q, k, v, **kw)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_flash_attention_rejects_what_it_cannot_take(dev):
    q, k, v = _attn_inputs(1, 2, 2, 8, 8, 48, "f32", dev, seed=4)
    with pytest.raises(ValueError, match="head dim"):
        gqa_attention_op(q, k, v)
    q, k, v = _attn_inputs(1, 2, 2, 8, 8, 32, "f32", dev, seed=4)
    with pytest.raises(TypeError):
        gqa_attention_op(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="aligned"):
        gqa_attention_op(q[..., 1:17], k[..., :16], v[..., :16])
    with pytest.raises(ValueError, match="is on"):
        gqa_attention_op(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        gqa_attention_op(q, k, v, window=0)


@pytest.mark.parametrize("name", ["danube", "stablelm"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_transformer_on_the_card(dev, name, dtype):
    """REDUCED prefill and three decode steps (the last past the buffer
    end): kernel path vs plain path on the card, and vs the CPU in f32."""
    base = {"danube": h2o_danube_1_8b.REDUCED, "stablelm": stablelm_1_6b.REDUCED}[name]
    cfg = dataclasses.replace(base, dtype=STORAGE[dtype])
    model = Transformer(cfg, device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40))

    def run(m, device):
        caches = init_cache(cfg, 3, 48, device=device)
        before = launch_counts()["flash_attention"]
        out = [m.prefill(toks, caches)[0]]
        for i, pos in enumerate((40, 41, 51)):
            out.append(m.decode_step(caches, toks[:, i : i + 1], pos)[0])
        if device != "cpu":
            torch.cuda.synchronize()
        return torch.stack(out), caches, launch_counts()["flash_attention"] - before

    got, got_c, n = run(model, dev)
    assert n == 4 * cfg.n_layers
    model.use_kernel = False
    want, want_c, m = run(model, dev)
    assert m == 0
    _close(got, want, _tol(dtype))
    _close(got_c, want_c, _tol(dtype))
    if dtype == "f32":
        cpu = Transformer(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        host, host_c, _ = run(cpu, "cpu")
        _close(got, host, _tol(dtype))
        _close(got_c, host_c, _tol(dtype))


# ---------------------------------------------------------------------------
# B2 lp_round on the tensor cores (3xTF32; bf16 one product) and B4
# csr_aggregate on live row lengths


def _lp_inputs(n, s, dtype, dev, seed, density=0.06):
    """A non-negative, sparse-ish A scaled like an LP operator (row sums
    about 0.9), F and base in [0, 1)."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) * (rng.random((n, n)) < density)
    A = 0.9 * A / np.maximum(A.sum(axis=1, keepdims=True), 1e-30)
    sdt = STORAGE[dtype]
    return tuple(
        torch.from_numpy(x.astype(np.float32)).to(dev, sdt)
        for x in (A, rng.random((n, s)), rng.random((n, s)))
    )


_EDGES = (63, 64, 65, 127, 128, 129, 255, 256, 257)


@pytest.mark.parametrize(
    "n,s",
    [(e, e) for e in _EDGES]
    + [(63, 257), (257, 65), (129, 64), (256, 127), (130, 4396), (4396, 129), (4396, 4396)],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lp_round_at_tile_edges(dev, n, s, dtype):
    """Ragged row, column and k tiles; N % 4 != 0 takes the padded-A route."""
    A, F, base = _lp_inputs(n, s, dtype, dev, seed=7 * n + s)
    before = launch_counts()["lp_round"]
    out = lp_round_op(A, F, base, c=0.25)
    torch.cuda.synchronize()
    assert launch_counts()["lp_round"] == before + 1
    assert out.dtype == STORAGE[dtype] and out.shape == (n, s)
    _close(out, lp_round_ref(A, F, base, 0.25), _tol(dtype))
    assert torch.equal(out, lp_round_op(A, F, base, c=0.25))  # fixed k order


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lp_round_takes_an_unaligned_a(dev, dtype):
    """A starting one element past a 16-byte boundary: TMA cannot read it
    in place, so the pre-pass copies it."""
    n, s = 200, 96
    A, F, base = _lp_inputs(n, s, dtype, dev, seed=5)
    flat = torch.empty(n * n + 1, device=dev, dtype=STORAGE[dtype])
    shifted = flat[1:].view(n, n)
    shifted.copy_(A)
    out = lp_round_op(shifted, F, base, c=0.5)
    torch.cuda.synchronize()
    _close(out, lp_round_ref(A, F, base, 0.5), _tol(dtype))


@pytest.mark.parametrize("n,s", [(1000, 1111), (1030, 700), (4396, 4396)])
def test_lp_round_f32_holds_the_f64_gate(dev, n, s):
    """Against an f64 product the kernel's max|Δ| is at most 4x the plain
    f32 product's (chip_smoke.B2_F64_FACTOR); N = 1030 takes the padded-A
    route."""
    A, F, base = _lp_inputs(n, s, "f32", dev, seed=n + s)
    want = 0.25 * base.double() + A.double() @ F.double()
    plain = float((lp_round_ref(A, F, base, 0.25).double() - want).abs().max())
    got = float((lp_round_op(A, F, base, c=0.25).double() - want).abs().max())
    assert 0.0 < plain and got <= 4.0 * plain


@pytest.mark.parametrize(
    "m,n,d,s",
    [
        (300, 500, 40, 16),  # 4 lanes, 8 rows of different lengths per warp
        (301, 400, 89, 1),  # one lane a row, 32 rows per warp
        (257, 300, 89, 100),  # the GCN's first layer: 25 lanes of 4 columns
        (64, 90, 130, 300),  # three column tiles, the last ragged
        (70, 80, 12, 2),  # two-column lanes
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_aggregate_stops_at_live_lengths(dev, m, n, d, s, dtype):
    """Rows of 0 and D live slots and ragged ones between; the sums equal
    the plain version's and, bit for bit, the launch without ``live``."""
    b = _padded_bucket(m, n, d, s, dtype, dev, seed=m + d + s)
    assert int(b["live"].lengths[0]) == 0 and int(b["live"].lengths[1]) == d
    args = (b["nbr"], b["wgt"], b["F"])
    before = launch_counts()["csr_aggregate"]
    out = csr_aggregate_op(*args, live=b["live"])
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate"] == before + 1
    _close(out, csr_aggregate_ref(*args), _tol(dtype))
    assert torch.equal(out, csr_aggregate_op(*args))  # live=None: every slot, same sums
    assert torch.equal(out, csr_aggregate_op(*args, live=b["live"]))


@pytest.mark.parametrize("s", [16, 1, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_aggregate_with_live_keeps_nan_from_the_pad_row(dev, s, dtype):
    """NaN and Inf in the F row that the pads name reach exactly the rows
    the plain version (which sums every pad) puts them in."""
    pad_id = 7
    b = _padded_bucket(60, 80, 48, s, dtype, dev, seed=s + 3, pad_id=pad_id)
    b["F"][pad_id, 0] = float("nan")
    b["F"][pad_id, s - 1] = float("inf") if s > 1 else float("nan")
    got = csr_aggregate_op(b["nbr"], b["wgt"], b["F"], live=b["live"])
    want = csr_aggregate_ref(b["nbr"], b["wgt"], b["F"])
    torch.cuda.synchronize()
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isnan(w[:, 0]).any()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, equal_nan=True, **_tol(dtype))


def test_gcn_with_live_on_the_card(dev):
    """The forward on the operator's live lengths launches one aggregate
    per layer and equals the forward over every slot."""
    data = planted_partition_graph(3000, 20000, 7, 100, seed=1, device=dev)
    cfg = GCNConfig(name="gcn", d_feat=100, n_classes=7)
    model = GCN(cfg, device=dev)
    nbr, wgt, live = gcn_adjacency_live(data.edges, device=dev)
    feats = torch.from_numpy(data.feats).to(dev)
    before = launch_counts()["csr_aggregate"]
    got = model(feats, nbr, wgt, live)
    torch.cuda.synchronize()
    assert launch_counts()["csr_aggregate"] - before == cfg.n_layers
    assert torch.equal(got, model(feats, nbr, wgt))
    model.use_kernel = False
    _close(got, model(feats, nbr, wgt), _tol("f32"))
