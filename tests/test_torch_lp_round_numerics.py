"""The 3xTF32 arithmetic of B2 ``lp_round``, emulated in numpy.

``csrc/lp_round.cu`` splits every f32 operand into two TF32 terms,
``hi = rna(x)`` (round to nearest, ties away from zero, to 10 mantissa
bits) and ``lo = rna(x - hi)``, and sums ``A_hi·F_hi + A_hi·F_lo +
A_lo·F_hi`` on the tensor cores: each product is exact in f32, each
8-deep k-step's products join one f32 accumulator, and ``c·base`` is added
in the epilogue with one rounding.  The card holds the kernel to an f64
product: its max|Δ| may be at most ``chip_smoke.B2_F64_FACTOR`` (4) times
that of the plain f32 product on the same inputs, and a kernel with the
hi·hi product alone must fail that gate (``F32_TOL`` cannot tell the two
apart: the outputs lie below 1, where ``atol`` decides).  These tests are
the design's evidence, runnable without a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lp_blockspmm import lp_round
from repro_torch.kernels.lp_blockspmm import lp_round_ref, regime

F32_TOL = dict(rtol=2e-4, atol=5e-4)  # tests/test_kernels.py::_tol
F64_FACTOR = 4.0  # chip_smoke.B2_F64_FACTOR
K_STEP = 8  # the depth of one TF32 wgmma


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 (10 mantissa bits), ties away from zero: the
    kernel's ``tf32_rna`` on the bits."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulate(A, F, base, c, *, products=3):
    """The kernel's arithmetic: split operands, exact products, one f32
    accumulator rounded after each 8-deep k-step, ``c·base`` added with
    one rounding (``fmaf``).  ``products=1`` keeps hi·hi alone."""
    a_hi, a_lo = split(A)
    f_hi, f_lo = split(F)
    terms = [(a_hi, f_hi), (a_hi, f_lo), (a_lo, f_hi)][:products]
    acc = np.zeros((A.shape[0], F.shape[1]), dtype=np.float32)
    for k0 in range(0, A.shape[1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        step = sum(a[:, ks].astype(np.float64) @ f[ks].astype(np.float64) for a, f in terms)
        acc = (acc.astype(np.float64) + step).astype(np.float32)
    return (c * base.astype(np.float64) + acc).astype(np.float32)


def lp_inputs(n, s, seed, density=0.06):
    """A non-negative, sparse-ish A scaled like an LP operator (row sums
    about 0.9), F and base in [0, 1)."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) * (rng.random((n, n)) < density)
    A = (0.9 * A / np.maximum(A.sum(axis=1, keepdims=True), 1e-30)).astype(np.float32)
    F = rng.random((n, s)).astype(np.float32)
    base = rng.random((n, s)).astype(np.float32)
    return A, F, base


def f64_error(got, A, F, base, c):
    want = c * base.astype(np.float64) + A.astype(np.float64) @ F.astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want)))


def plain_f32(A, F, base, c):
    return lp_round_ref(*(torch.from_numpy(x) for x in (A, F, base)), c).numpy()


def test_rna_rounds_to_ten_mantissa_bits_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                  np.float32(np.inf), np.float32(-0.0)], dtype=np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got[:4], [one + ulp, -(one + ulp), one, one + ulp])
    assert np.isinf(got[4]) and got[5] == 0 and np.signbit(got[5])
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(10_000) * 10.0 ** rng.integers(-8, 8, 10_000)).astype(np.float32)
    hi, lo = split(y)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    rel = np.abs((hi.astype(np.float64) + lo) - y) / np.abs(y)
    assert rel.max() < 2.0**-21  # hi + lo keeps about 22 bits of the 24


def test_bf16_values_are_exact_in_tf32():
    """The bf16 regime issues the hi·hi product alone: its lo terms are 0."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    b = x.to(torch.bfloat16).float().numpy()
    hi, lo = split(b)
    np.testing.assert_array_equal(hi, b)
    assert not lo.any()
    assert regime(torch.bfloat16) == "1xtf32" and regime(torch.float32) == "3xtf32"


@pytest.mark.parametrize("n,s", [(512, 128), (257, 130)])
def test_three_products_agree_with_the_pallas_kernel(n, s):
    A, F, base = lp_inputs(n, s, seed=n + s)
    got = emulate(A, F, base, 0.36)
    kern = lp_round(jnp.asarray(A), jnp.asarray(F), jnp.asarray(base), c=0.36,
                    bm=128, bs=128, bk=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got, plain_f32(A, F, base, 0.36), **F32_TOL)


@pytest.mark.parametrize("n,s,seed", [(1024, 256, 0), (768, 192, 1)])
def test_three_products_pass_the_f64_gate_and_one_does_not(n, s, seed):
    """The card's gate, on the CPU: 3xTF32 within 4x the f32 product's
    error against f64; the hi·hi product alone far outside it, though it
    passes F32_TOL."""
    A, F, base = lp_inputs(n, s, seed=seed)
    c = 0.25
    plain = f64_error(plain_f32(A, F, base, c), A, F, base, c)
    three = f64_error(emulate(A, F, base, c), A, F, base, c)
    one_out = emulate(A, F, base, c, products=1)
    one = f64_error(one_out, A, F, base, c)
    assert 0 < plain and three <= F64_FACTOR * plain
    assert one > F64_FACTOR * plain
    np.testing.assert_allclose(one_out, plain_f32(A, F, base, c), **F32_TOL)
