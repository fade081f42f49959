"""B5 ``embedding_bag`` on the card (marker ``gpu``; skipped without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_embedding_bag_gpu.py

Every regime of the kernel (``vector``: 16-byte lanes; ``scalar``: one
element a lane; ``slots``: lanes over K) at the edges of its tiles, a grid
that walks its tiles more than once, a table view with a storage offset,
one hot row for every bag and the strided ``out`` of the Wide & Deep MLP
input.  Each launch is held to the plain version at the tolerances of
``tests/test_kernels.py::_tol``; weight 1.0 must be an exact gather and
two launches must give the same bytes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref, launch_plan

pytestmark = pytest.mark.gpu

STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=2e-4, atol=5e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def _inputs(v, d, b, k, dtype, dev, seed, *, offset=0, hot=None):
    rng = np.random.default_rng(seed)
    sdt = STORAGE[dtype]
    flat = torch.from_numpy(rng.standard_normal(v * d + offset).astype(np.float32)).to(dev, sdt)
    tab = flat[offset:].view(v, d)
    ids = rng.integers(0, v, (b, k)) if hot is None else np.full((b, k), hot)
    idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.random((b, k)).astype(np.float32)).to(dev, sdt)
    return tab, idx, w


def _check(tab, idx, w, dtype, *, out=None, want_regime=None):
    before = launch_counts()["embedding_bag"]
    got = embedding_bag_op(tab, idx, w, out=out)
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] == before + 1
    if want_regime is not None:
        assert launch_plan(tab, idx, w, got).regime == want_regime
    want = embedding_bag_ref(tab, idx, w)
    flat = got.reshape(want.shape)
    assert got.dtype == STORAGE[dtype]
    _close(flat, want, _tol(dtype))
    first = flat.clone()
    again = embedding_bag_op(tab, idx, w, out=out)  # into the same layout
    torch.cuda.synchronize()
    assert torch.equal(first, again.reshape(want.shape))  # byte-identical relaunch
    ones = torch.ones_like(w)
    if idx.shape[1] == 1:  # one slot of weight 1.0: an exact gather
        assert torch.equal(embedding_bag_op(tab, idx, ones), tab[idx[:, 0].long()])
    return got


@pytest.mark.parametrize("b", [1, 31, 33, 32 * 8 + 1])
@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("d", [32, 16, 36])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_rows_regimes_at_tile_edges(dev, dtype, d, k, b):
    tab, idx, w = _inputs(700, d, b, k, dtype, dev, seed=b + 7 * k + d)
    _check(tab, idx, w, dtype, want_regime="scalar" if d == 36 else "vector")


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_table_view_with_a_storage_offset(dev, dtype, k):
    tab, idx, w = _inputs(900, 32, 333, k, dtype, dev, seed=k, offset=1)
    assert tab.storage_offset() == 1
    _check(tab, idx, w, dtype, want_regime="scalar")


@pytest.mark.parametrize("d,k", [(32, 1), (32, 3), (36, 1), (1, 40)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_persistent_grid_walks_its_tiles(dev, dtype, d, k):
    # 400,000 bags: more warp tiles than the persistent grid has warps
    tab, idx, w = _inputs(5000, d, 400_000, k, dtype, dev, seed=d + k)
    _check(tab, idx, w, dtype)


@pytest.mark.parametrize("d,k", [(32, 1), (32, 3), (1, 40)])
def test_embedding_bag_every_bag_on_one_hot_row(dev, d, k):
    tab, idx, w = _inputs(1000, d, 300_001, k, "f32", dev, seed=3, hot=17)
    _check(tab, idx, w, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_embedding_bag_strided_out_of_the_mlp_input(dev, dtype, k):
    rows, g, d, ld = 1001, 40, 32, 1296  # Wide & Deep FULL: 40 fields, 1,293 padded
    tab, idx, w = _inputs(3000, d, rows * g, k, dtype, dev, seed=11 + k)
    buf = torch.full((rows, ld), float("nan"), dtype=STORAGE[dtype], device=dev)
    view = buf[:, : g * d].view(rows, g, d)
    got = _check(tab, idx, w, dtype, out=view, want_regime="vector")
    assert got is view
    assert torch.isnan(buf[:, g * d :]).all()  # the dense features' tail is left alone


def test_embedding_bag_strided_out_unpadded_takes_the_scalar_regime(dev):
    rows, g, d, ld = 65, 40, 32, 1293
    tab, idx, w = _inputs(3000, d, rows * g, 1, "f32", dev, seed=5)
    buf = torch.full((rows, ld), float("nan"), device=dev)
    _check(tab, idx, w, "f32", out=buf[:, : g * d].view(rows, g, d), want_regime="scalar")
    assert torch.isnan(buf[:, g * d :]).all()


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("k,shifted", [(40, False), (40, True), (7, False), (300, False),
                                       (0, False)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_bag_slots_regime(dev, dtype, d, k, shifted):
    tab, idx, w = _inputs(900, d, 2049, k, dtype, dev, seed=d + k)
    if shifted:  # ids one element past a 16-byte boundary: scalar id loads
        store = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=dev)
        idx = store[1:].view(idx.shape).copy_(idx)
    got = _check(tab, idx, w, dtype, want_regime="slots")
    if k == 0:
        assert not got.any()


def test_embedding_bag_rejects_a_bad_strided_out(dev):
    tab, idx, w = _inputs(50, 8, 12, 2, "f32", dev, seed=2)
    before = launch_counts()["embedding_bag"]
    with pytest.raises(ValueError, match="strides"):  # columns not contiguous
        embedding_bag_op(tab, idx, w, out=torch.empty(3, 8, 4, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="strides"):  # rows that overlap: ld < G·D
        embedding_bag_op(tab, idx, w,
                         out=torch.empty(64, device=dev).as_strided((3, 4, 8), (8, 8, 1)))
    with pytest.raises(ValueError, match="shape"):
        embedding_bag_op(tab, idx, w, out=torch.empty(2, 4, 8, device=dev))
    with pytest.raises(ValueError, match="shape"):
        embedding_bag_op(tab, idx, w, out=torch.empty(12, 9, device=dev))
    with pytest.raises(TypeError):
        embedding_bag_op(tab, idx, w, out=torch.empty(3, 4, 8, device=dev, dtype=torch.float64))
    assert launch_counts()["embedding_bag"] == before
