"""Port kernels vs the JAX reference: plain versions and wrappers on the CPU.

Each input is drawn once with numpy and handed to both packages.  The
port's plain versions (what its wrappers run for CPU tensors) are held
against ``repro``'s Pallas kernels in interpret mode and against its
oracles, at the tolerances of ``tests/test_kernels.py::_tol``.
The CUDA kernels themselves run only on the card (``test_torch_gpu.py``
and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.structures import erdos_renyi
from repro.kernels.embedding_bag import embedding_bag, embedding_bag_ref as jax_bag_ref
from repro.kernels.lp_blockspmm import lp_round, lp_round_ref as jax_lp_round_ref
from repro.kernels.segment_reduce import (
    csr_aggregate,
    csr_aggregate_ref as jax_csr_aggregate_ref,
    csr_round,
    csr_round_ref as jax_csr_round_ref,
    csr_round_residual,
    csr_round_residual_ref as jax_csr_ref,
)
from repro_torch.graph.structures import EdgeList, PaddedCSR
from repro_torch.kernels import SOURCES, launch_counts
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref
from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
from repro_torch.kernels.segment_reduce import (
    csr_aggregate_op,
    csr_aggregate_ref,
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
    rows_per_block,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=2e-4, atol=5e-4)


def _both(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(np.ascontiguousarray(x)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _csr_inputs(m, n, d, s, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (m, d)).astype(np.int32)
    wgt = (rng.random((m, d)) * (rng.random((m, d)) < 0.7)).astype(np.float32)
    F = rng.random((n, s)).astype(np.float32)
    base = rng.random((m, s)).astype(np.float32)
    prev = rng.random((m, s)).astype(np.float32)
    return nbr, wgt, F, base, prev


class TestCSRRoundResidual:
    """B1: plain version vs the Pallas kernel (interpret) and the oracle."""

    @pytest.mark.parametrize(
        "m,n,d,s",
        [
            (128, 128, 8, 32),  # aligned
            (200, 150, 11, 37),  # padded tails on every axis
            (64, 300, 33, 16),  # degree > one bd slab
        ],
    )
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, m, n, d, s, dtype):
        nbr, wgt, F, base, prev = _csr_inputs(m, n, d, s, seed=m + n + d + s)
        jw, tw = _both(wgt, dtype)
        jF, tF = _both(F, dtype)
        jb, tb = _both(base, "f32")
        jp, tp = _both(prev, "f32")
        jn, tn = jnp.asarray(nbr), torch.from_numpy(nbr)

        got, gd = csr_round_residual_ref(tn, tw, tF, tb, tp, 0.25)
        kern, kd = csr_round_residual(
            jn, jw, jF, jb, jp, c=0.25, bn=64, bs=32, bd=8, interpret=True
        )
        want, wd = jax_csr_ref(jn, jw, jF, jb, jp, 0.25)
        assert got.dtype == torch.float32 and got.shape == (m, s)
        assert gd.shape == (1, s)
        for ref_out, ref_delta in ((kern, kd), (want, wd)):
            np.testing.assert_allclose(_np(got), _np(ref_out)[:m, :s], **_tol(dtype))
            # the kernel's delta is a per-row-block partial: reduce, compare
            np.testing.assert_allclose(
                _np(gd)[0], _np(ref_delta).max(axis=0)[:s], **_tol(dtype)
            )

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_op_on_cpu_is_the_plain_version(self, dtype):
        nbr, wgt, F, base, prev = _csr_inputs(40, 60, 16, 24, seed=3)
        _, tw = _both(wgt, dtype)
        _, tF = _both(F, dtype)
        tn, tb, tp = (torch.from_numpy(a) for a in (nbr, base, prev))
        before = launch_counts()
        want, wd = csr_round_residual_ref(tn, tw, tF, tb, tp, 0.3)
        buf = torch.full((40, 24), float("nan"))
        got, gd = csr_round_residual_op(tn, tw, tF, tb, tp, c=0.3, out=buf)
        assert got is buf
        assert torch.equal(got, want) and torch.equal(gd, wd)
        assert launch_counts() == before  # the plain version is no launch

    def test_residual_zero_at_fixed_point(self):
        nbr, wgt, F, base, _ = _csr_inputs(64, 64, 8, 16, seed=5)
        tn, tw, tF, tb = (torch.from_numpy(a) for a in (nbr, wgt, F, base))
        out, _ = csr_round_residual_ref(tn, tw, tF, tb, tb, 0.3)
        _, delta = csr_round_residual_ref(tn, tw, tF, tb, out, 0.3)
        assert float(delta.max()) == 0.0

    def test_column_chunked_gather_agrees(self, monkeypatch):
        """Column chunking of the plain version changes only the rounding
        (the BLAS blocking of each chunk's einsum), not the function."""
        from repro_torch.kernels.segment_reduce import ref

        nbr, wgt, F, base, prev = _csr_inputs(50, 70, 12, 45, seed=9)
        args = [torch.from_numpy(a) for a in (nbr, wgt, F, base, prev)]
        whole = csr_round_residual_ref(*args, 0.25)
        monkeypatch.setattr(ref, "GATHER_BUDGET", 50 * 12 * 7)  # 7-column chunks
        chunked = csr_round_residual_ref(*args, 0.25)
        for a, b in zip(whole, chunked):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("width", [8, 136, 2208, 5000])
    def test_rows_per_block_covers_every_width(self, width):
        rpb = rows_per_block(width)
        assert 1 <= rpb <= 64
        assert rpb == 1 or rpb * width <= 4096


class TestCSRRound:
    """B3: plain version vs the Pallas kernel (interpret) and the oracle."""

    @pytest.mark.parametrize(
        "m,n,d,s",
        [
            (128, 128, 8, 32),  # aligned
            (200, 150, 11, 37),  # padded tails on every axis
            (64, 300, 33, 16),  # degree > one bd slab
            (5, 90, 130, 140),  # wider than one staged slab, ragged S
        ],
    )
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, m, n, d, s, dtype):
        nbr, wgt, F, base, _ = _csr_inputs(m, n, d, s, seed=m * 7 + n + d + s)
        jw, tw = _both(wgt, dtype)
        jF, tF = _both(F, dtype)
        jb, tb = _both(base, "f32")
        jn, tn = jnp.asarray(nbr), torch.from_numpy(nbr)

        got = csr_round_ref(tn, tw, tF, tb, 0.25)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (m, s)
        kern = csr_round(jn, jw, jF, jb, c=0.25, bn=64, bs=32, bd=8, interpret=True)
        want = jax_csr_round_ref(jn, jw, jF, jb, 0.25)
        assert want.dtype == DTYPES[dtype][0]
        for ref_out in (kern, want):
            np.testing.assert_allclose(_np(got), _np(ref_out)[:m, :s], **_tol(dtype))

    def test_bf16_rounds_like_the_oracle(self):
        """The reference's oracle rounds the sum to bf16 before adding
        ``c·base``; the plain version does the same, bit for bit."""
        nbr, wgt, F, base, _ = _csr_inputs(96, 120, 24, 40, seed=21)
        jw, tw = _both(wgt, "bf16")
        jF, tF = _both(F, "bf16")
        got = csr_round_ref(torch.from_numpy(nbr), tw, tF, torch.from_numpy(base), 0.25)
        want = jax_csr_round_ref(jnp.asarray(nbr), jw, jF, jnp.asarray(base), 0.25)
        np.testing.assert_array_equal(_np(got), _np(want))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_op_on_cpu_is_the_plain_version(self, dtype):
        nbr, wgt, F, base, _ = _csr_inputs(40, 60, 16, 24, seed=4)
        _, tw = _both(wgt, dtype)
        _, tF = _both(F, dtype)
        tn, tb = torch.from_numpy(nbr), torch.from_numpy(base)
        before = launch_counts()
        want = csr_round_ref(tn, tw, tF, tb, 0.3)
        buf = torch.full((40, 24), float("nan"), dtype=tF.dtype)
        got = csr_round_op(tn, tw, tF, tb, c=0.3, out=buf)
        assert got is buf and torch.equal(got, want)
        assert torch.equal(csr_round_op(tn, tw, tF, tb, c=0.3), want)
        assert launch_counts() == before  # the plain version is no launch

    def test_round_residual_and_round_agree_in_f32(self):
        nbr, wgt, F, base, prev = _csr_inputs(70, 80, 12, 30, seed=6)
        args = [torch.from_numpy(a) for a in (nbr, wgt, F, base)]
        out, _ = csr_round_residual_ref(*args, torch.from_numpy(prev), 0.4)
        assert torch.equal(csr_round_ref(*args, 0.4), out)

    def test_is_built_and_counted_with_the_others(self):
        assert SOURCES == (
            "csr_round_residual.cu",
            "csr_round.cu",
            "lp_round.cu",
            "csr_aggregate.cu",
            "embedding_bag.cu",
        )
        assert set(launch_counts()) == {
            "csr_round_residual",
            "csr_round",
            "lp_round",
            "csr_aggregate",
            "embedding_bag",
        }


class TestCSRAggregate:
    """B4: plain version vs the Pallas kernel (interpret) and the oracle."""

    @pytest.mark.parametrize("n,d,s", [(128, 8, 32), (200, 11, 37), (256, 33, 128)])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, n, d, s, dtype):
        nbr, wgt, F, _, _ = _csr_inputs(n, n, d, s, seed=n + d + s)
        jw, tw = _both(wgt, dtype)
        jF, tF = _both(F, dtype)
        jn, tn = jnp.asarray(nbr), torch.from_numpy(nbr)

        got = csr_aggregate_ref(tn, tw, tF)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (n, s)
        kern = csr_aggregate(jn, jw, jF, bn=64, bs=32, bd=8, interpret=True)
        want = jax_csr_aggregate_ref(jn, jw, jF)
        assert want.dtype == DTYPES[dtype][0]  # F's dtype in both packages
        for ref_out in (kern, want):
            np.testing.assert_allclose(_np(got), _np(ref_out), **_tol(dtype))
        assert torch.equal(csr_aggregate_op(tn, tw, tF), got)

    def test_matches_dense_spmm(self):
        """The port's padded CSR of a graph, aggregated, is dense ``A @ F``."""
        ref_edges = erdos_renyi(150, 800, seed=3)
        edges = EdgeList(ref_edges.src, ref_edges.dst, ref_edges.w, 150)
        csr = PaddedCSR.from_edgelist(edges, device="cpu")
        F = np.random.default_rng(3).random((150, 20)).astype(np.float32)
        got = csr_aggregate_op(
            torch.from_numpy(csr.nbr), torch.from_numpy(csr.wgt), torch.from_numpy(F)
        )
        np.testing.assert_allclose(got.numpy(), edges.to_dense() @ F, rtol=1e-4, atol=1e-5)

    def test_row_chunked_gather_agrees(self, monkeypatch):
        """Past the budget in M·D alone the plain version chunks rows (as
        at ogb_products, M·D = 218 M); rows are independent, so only the
        library's rounding order may change."""
        from repro_torch.kernels.segment_reduce import ref

        nbr, wgt, F, _, _ = _csr_inputs(90, 70, 12, 45, seed=10)
        args = [torch.from_numpy(a) for a in (nbr, wgt, F)]
        whole = csr_aggregate_ref(*args)
        monkeypatch.setattr(ref, "GATHER_BUDGET", 12 * 45 * 8)  # M·D > budget
        chunked = csr_aggregate_ref(*args)
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
        monkeypatch.setattr(ref, "GATHER_BUDGET", 20)  # below one row's slots
        single = csr_aggregate_ref(*args)
        np.testing.assert_allclose(single.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_op_on_cpu_is_the_plain_version(self, dtype):
        nbr, wgt, F, _, _ = _csr_inputs(40, 60, 16, 24, seed=4)
        _, tw = _both(wgt, dtype)
        _, tF = _both(F, dtype)
        tn = torch.from_numpy(nbr)
        before = launch_counts()
        want = csr_aggregate_ref(tn, tw, tF)
        buf = torch.full((40, 24), float("nan"), dtype=tF.dtype)
        got = csr_aggregate_op(tn, tw, tF, out=buf)
        assert got is buf and torch.equal(got, want)
        assert launch_counts() == before  # the plain version is no launch


class TestEmbeddingBag:
    """B5: plain version vs the Pallas kernel (interpret) and the oracle."""

    @staticmethod
    def _inputs(v, d, b, k, seed):
        rng = np.random.default_rng(seed)
        tab = rng.random((v, d)).astype(np.float32)
        idx = rng.integers(0, v, (b, k)).astype(np.int32)
        w = rng.random((b, k)).astype(np.float32)
        return tab, idx, w

    @pytest.mark.parametrize(
        "v,d,b,k",
        [
            (1000, 32, 128, 5),
            (4096, 16, 300, 8),
            (512, 64, 64, 40),
            (700, 32, 200, 1),  # the deep lookup: one slot per bag
            (900, 1, 150, 40),  # the wide lookup: D = 1
        ],
    )
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, v, d, b, k, dtype):
        tab, idx, w = self._inputs(v, d, b, k, seed=v + d + b + k)
        jt, tt = _both(tab, dtype)
        jw, tw = _both(w, dtype)
        ji, ti = jnp.asarray(idx), torch.from_numpy(idx)
        got = embedding_bag_ref(tt, ti, tw)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, d)
        kern = embedding_bag(jt, ji, jw, bb=64, bv=256, interpret=True)
        want = jax_bag_ref(jt, ji, jw)
        for ref_out in (kern, want):
            np.testing.assert_allclose(_np(got), _np(ref_out), **_tol(dtype))
        assert torch.equal(embedding_bag_op(tt, ti, tw), got)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_one_slot_of_weight_one_is_an_exact_gather(self, dtype):
        tab, idx, _ = self._inputs(300, 32, 500, 1, seed=8)
        _, tt = _both(tab, dtype)
        got = embedding_bag_op(tt, torch.from_numpy(idx), torch.ones((500, 1), dtype=tt.dtype))
        assert torch.equal(got, tt[torch.from_numpy(idx[:, 0]).long()])

    def test_counts_each_index_once(self):
        tab = torch.from_numpy(np.eye(100, 8, dtype=np.float32))
        got = embedding_bag_op(tab, torch.tensor([[3, 3, 3]], dtype=torch.int32), torch.ones(1, 3))
        assert torch.equal(got, 3 * tab[3:4])

    def test_op_on_cpu_is_the_plain_version(self):
        tab, idx, w = (torch.from_numpy(a) for a in self._inputs(64, 8, 20, 6, seed=2))
        before = launch_counts()
        buf = torch.full((20, 8), float("nan"))
        got = embedding_bag_op(tab, idx, w, out=buf)
        assert got is buf and torch.equal(got, embedding_bag_ref(tab, idx, w))
        assert launch_counts() == before


class TestLPRound:
    """B2: plain version vs the Pallas kernel (interpret) and the oracle."""

    @pytest.mark.parametrize("n,s", [(128, 128), (257, 130), (384, 96), (64, 640)])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, n, s, dtype):
        rng = np.random.default_rng(n * 1000 + s)
        A = (rng.random((n, n)) / n).astype(np.float32)
        F = rng.random((n, s)).astype(np.float32)
        base = rng.random((n, s)).astype(np.float32)
        jA, tA = _both(A, dtype)
        jF, tF = _both(F, dtype)
        jb, tb = _both(base, dtype)
        got = lp_round_ref(tA, tF, tb, 0.36)
        assert got.dtype == tF.dtype and got.shape == (n, s)
        kern = lp_round(jA, jF, jb, c=0.36, bm=128, bs=128, bk=128, interpret=True)
        want = jax_lp_round_ref(jA, jF, jb, 0.36)
        for ref_out in (kern, want):
            np.testing.assert_allclose(_np(got), _np(ref_out), **_tol(dtype))

    def test_op_on_cpu_is_the_plain_version(self):
        rng = np.random.default_rng(11)
        A, F, base = (
            torch.from_numpy(rng.random(shape).astype(np.float32))
            for shape in ((48, 48), (48, 20), (48, 20))
        )
        before = launch_counts()
        assert torch.equal(lp_round_op(A, F, base, c=0.1), lp_round_ref(A, F, base, 0.1))
        assert launch_counts() == before


class TestWrappersNeverFallBack:
    """A tensor off the CPU goes to the kernel or raises — never the plain
    version.  ``meta`` tensors stand in for a device without a kernel."""

    def test_csr_round_residual_raises_off_cpu(self):
        meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            csr_round_residual_op(
                meta(4, 8, dt=torch.int32), meta(4, 8), meta(10, 3), meta(4, 3),
                meta(4, 3), c=0.25,
            )

    def test_csr_round_raises_off_cpu(self):
        meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            csr_round_op(
                meta(4, 8, dt=torch.int32), meta(4, 8), meta(10, 3), meta(4, 3), c=0.25
            )

    def test_lp_round_raises_off_cpu(self):
        meta = lambda *shape: torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            lp_round_op(meta(6, 6), meta(6, 2), meta(6, 2), c=1.0)

    def test_csr_aggregate_raises_off_cpu(self):
        meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            csr_aggregate_op(meta(4, 8, dt=torch.int32), meta(4, 8), meta(10, 3))

    def test_embedding_bag_raises_off_cpu(self):
        meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            embedding_bag_op(meta(10, 4), meta(3, 2, dt=torch.int32), meta(3, 2))

    def test_mixed_devices_raise(self):
        cpu = torch.zeros(6, 6)
        with pytest.raises(ValueError):
            lp_round_op(cpu, torch.empty(6, 2, device="meta"), torch.zeros(6, 2), c=1.0)
