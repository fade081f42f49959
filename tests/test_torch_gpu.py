"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs at the tolerances of ``tests/test_kernels.py::_tol`` (the plain
versions are held against the JAX reference by the CPU tests), and the
engines that launch them against the torch-op engines.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.solver import HeteroLP, LPConfig
from repro_torch.engine import make_engine
from repro_torch.kernels import launch_counts
from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
from repro_torch.kernels.segment_reduce import (
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
)
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
