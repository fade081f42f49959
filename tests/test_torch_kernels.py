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
from repro.kernels.flash_attention import (
    attention_ref as jax_attention_ref,
    flash_attention,
    gqa_attention_op as jax_gqa_attention_op,
)
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
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention_op,
    gqa_attention_op,
    gqa_attention_ref,
    ops as flash_ops,
)
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
            "flash_attention.cu",
        )
        assert set(launch_counts()) == {
            "csr_round_residual",
            "csr_round",
            "lp_round",
            "csr_aggregate",
            "csr_aggregate_backward",  # B4 again, launched by CSRAggregate's backward
            "embedding_bag",
            "flash_attention",
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


def _attn_inputs(shapes, name, seed):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(sh).astype(np.float32), name) for sh in shapes]


class TestFlashAttention:
    """B6: plain version vs the Pallas kernel (interpret) and the oracle."""

    @pytest.mark.parametrize(
        "b,h,lq,lk,d,window,q_offset",
        [  # tests/test_kernels.py::TestFlashAttention::test_sweep
            (2, 4, 128, 128, 64, None, 0),  # causal prefill
            (1, 2, 100, 100, 32, 48, 0),  # sliding window
            (2, 2, 1, 256, 64, None, 255),  # single-token decode
            (1, 3, 130, 200, 64, None, 70),  # chunked prefill (kv > q)
            (1, 1, 64, 512, 128, 128, 448),  # windowed decode chunk
        ],
    )
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_sweep_against_jax(self, b, h, lq, lk, d, window, q_offset, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(
            [(b, h, lq, d), (b, h, lk, d), (b, h, lk, d)], dtype, seed=lq + lk
        )
        kw = dict(causal=True, window=window, q_offset=q_offset)
        got = flash_attention_op(tq, tk, tv, **kw)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        pallas = flash_attention(jq, jk, jv, bq=64, bk=64, interpret=True, **kw)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
        np.testing.assert_allclose(_np(got), _np(jax_attention_ref(jq, jk, jv, **kw)), **_tol(dtype))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1), (6, 6)])
    def test_gqa_grouping(self, hq, hkv, dtype):
        b, l, d = 1, 64, 32
        (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(
            [(b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d)], dtype, seed=hq
        )
        got = gqa_attention_op(tq, tk, tv, window=24)
        want = jax_gqa_attention_op(jq, jk, jv, window=24, use_kernel=True, bq=32, bk=32)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
        g = hq // hkv
        oracle = jax_attention_ref(jq, jnp.repeat(jk, g, axis=1), jnp.repeat(jv, g, axis=1),
                                   window=24)
        np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))

    def test_window_equals_full_when_large(self):
        b, h, l, d = 1, 2, 96, 32
        (jq, tq), (jk, tk), (jv, tv) = _attn_inputs([(b, h, l, d)] * 3, "f32", seed=7)
        full = flash_attention_op(tq, tk, tv, window=None)
        win = flash_attention_op(tq, tk, tv, window=4 * l)
        np.testing.assert_allclose(full.numpy(), win.numpy(), rtol=1e-6)
        pallas = flash_attention(jq, jk, jv, window=4 * l, bq=32, bk=32, interpret=True)
        np.testing.assert_allclose(win.numpy(), _np(pallas), **_tol("f32"))

    def test_sequence_major_layout_is_the_same_function(self):
        (_, tq), (_, tk), (_, tv) = _attn_inputs([(2, 8, 9, 16), (2, 2, 30, 16), (2, 2, 30, 16)],
                                                 "f32", seed=8)
        want = gqa_attention_op(tq, tk, tv, window=5, q_offset=21)
        got = gqa_attention_op(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                               window=5, q_offset=21, layout="blhd")
        assert got.shape == (2, 9, 8, 16)
        assert torch.equal(got.transpose(1, 2), want)

    @pytest.mark.parametrize("window,q_offset", [(2, 10), (None, -2)])
    def test_rows_without_keys_are_nan_like_the_reference(self, window, q_offset):
        """repro's oracle and Pallas kernel (interpret) give NaN for a row
        that sees no key; the port's plain version (and kernel) follow."""
        (jq, tq), (jk, tk), (jv, tv) = _attn_inputs([(1, 2, 6, 32), (1, 2, 8, 32), (1, 2, 8, 32)],
                                                    "f32", seed=9)
        kw = dict(window=window, q_offset=q_offset)
        got = _np(flash_attention_op(tq, tk, tv, **kw))
        want = _np(jax_attention_ref(jq, jk, jv, **kw))
        pallas = _np(flash_attention(jq, jk, jv, bq=8, bk=8, interpret=True, **kw))
        nan = np.isnan(want)
        assert nan.any() and np.array_equal(np.isnan(got), nan)
        assert np.array_equal(np.isnan(pallas), nan)
        np.testing.assert_allclose(got[~nan], want[~nan], **_tol("f32"))

    def test_op_on_cpu_is_the_plain_version(self):
        (_, tq), (_, tk), (_, tv) = _attn_inputs([(1, 4, 5, 16), (1, 2, 12, 16), (1, 2, 12, 16)],
                                                 "f32", seed=10)
        before = launch_counts()
        want = attention_ref(tq, tk.repeat_interleave(2, 1), tv.repeat_interleave(2, 1),
                             window=4, q_offset=7)
        assert torch.equal(gqa_attention_op(tq, tk, tv, window=4, q_offset=7), want)
        assert launch_counts() == before

    @pytest.mark.parametrize(
        "lq,lk,window,q_offset,causal",
        [
            (40, 40, None, 0, True),  # causal prefill
            (40, 40, 6, 0, True),  # the window slices each chunk's keys
            (7, 60, 16, 50, True),  # a decode chunk past the window
            (9, 30, None, 21, True),  # kv longer than q
            (12, 20, 5, 3, False),  # window without the causal edge
            (6, 8, 2, 10, True),  # rows without keys: NaN
            (6, 8, None, -2, True),
            (6, 8, 1, 20, True),  # a whole chunk without keys
        ],
    )
    @pytest.mark.parametrize("chunk", [1, 4, 16])
    def test_chunked_plain_version_is_the_oracle(self, lq, lk, window, q_offset, causal, chunk):
        """Chunks scored against the keys their rows see give the oracle's
        output on every row, the NaN rows included."""
        (_, tq), (_, tk), (_, tv) = _attn_inputs(
            [(2, 8, lq, 16), (2, 2, lk, 16), (2, 2, lk, 16)], "f32", seed=lq * lk + chunk
        )
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want = attention_ref(tq, tk.repeat_interleave(4, 1), tv.repeat_interleave(4, 1), **kw)
        got = gqa_attention_ref(tq, tk, tv, chunk=chunk, **kw)
        np.testing.assert_array_equal(torch.isnan(got).numpy(), torch.isnan(want).numpy())
        keep = ~torch.isnan(want)
        np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(), rtol=1e-6, atol=1e-6)
        seq = gqa_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                                chunk=chunk, layout="blhd", **kw)
        assert torch.equal(seq.transpose(1, 2).isnan(), got.isnan())
        assert torch.equal(seq.transpose(1, 2)[keep], got[keep])

    def test_small_and_decode_shapes_go_to_the_kernel(self, monkeypatch):
        """``repro``'s op sends Lq·Lk < 128·128 to its oracle; the port's op
        sends every off-CPU call to the kernel (``meta`` stands in for a card)."""
        seen = []

        def fake_launch(q, k, v, out, **kw):
            seen.append((tuple(q.shape), tuple(k.shape), kw))
            return out

        monkeypatch.setattr(flash_ops, "_launch", fake_launch)
        meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
        out = gqa_attention_op(meta(2, 32, 1, 80), meta(2, 8, 4096, 80), meta(2, 8, 4096, 80),
                               window=4096, q_offset=4000)
        assert out.shape == (2, 32, 1, 80) and out.device.type == "meta"
        gqa_attention_op(meta(1, 4, 3, 16), meta(1, 2, 3, 16), meta(1, 2, 3, 16))
        assert [s[:2] for s in seen] == [((2, 1, 32, 80), (2, 4096, 8, 80)),
                                         ((1, 3, 4, 16), (1, 3, 2, 16))]
        assert seen[0][2] == dict(causal=True, window=4096, q_offset=4000)
        assert seen[1][2]["window"] == 0  # no window

    def test_rejects_what_it_cannot_take(self):
        t = torch.zeros(1, 4, 3, 16)
        with pytest.raises(ValueError, match="multiple"):
            gqa_attention_op(t, torch.zeros(1, 3, 3, 16), torch.zeros(1, 3, 3, 16))
        with pytest.raises(ValueError, match="window"):
            gqa_attention_op(t, t, t, window=0)
        with pytest.raises(ValueError, match="layout"):
            gqa_attention_op(t, t, t, layout="bhdl")
        with pytest.raises(ValueError, match="equal heads"):
            flash_attention_op(t, t[:, :2], t[:, :2])
        meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
        with pytest.raises(ValueError, match="head dim"):
            gqa_attention_op(meta(1, 2, 3, 48), meta(1, 2, 3, 48), meta(1, 2, 3, 48))


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

    def test_flash_attention_raises_off_cpu(self):
        meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
        with pytest.raises(ValueError, match="unsupported device"):
            gqa_attention_op(meta(1, 4, 1, 64), meta(1, 2, 8, 64), meta(1, 2, 8, 64))

    def test_mixed_devices_raise(self):
        cpu = torch.zeros(6, 6)
        with pytest.raises(ValueError):
            lp_round_op(cpu, torch.empty(6, 2, device="meta"), torch.zeros(6, 2), c=1.0)
