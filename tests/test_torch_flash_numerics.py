"""The bf16 arithmetic of B6's tensor-core regimes, emulated in plain torch.

``csrc/flash_attention.cu`` multiplies bf16 Q and K on the tensor cores
into f32 scores, runs the online softmax in f32 over key tiles (64 keys
a tile in the prefill tile; in the decode tile 4 warps take 32 keys each
of every stage and merge their states at the end), and
feeds P to the P.V product as two bf16 terms, ``P_hi = bf16(P)`` and
``P_lo = bf16(P - P_hi)``, each against the same bf16 V tile with f32
accumulation; the output is rounded to bf16 once.  The card holds the
kernel to its plain version at ``rtol=2e-2, atol=1e-5`` (one bf16 ulp,
``chip_smoke.FLASH_BF16_TOL``).  These tests are the design's evidence,
runnable without a card: the hi/lo split passes that gate, and a P
rounded once to bf16 (what a plain tensor-core flash forward does) does
not, because it moves outputs near zero by more than ``atol``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import DECODE_ROWS, gqa_attention_ref, regime

GATE = dict(rtol=2e-2, atol=1e-5)  # chip_smoke.FLASH_BF16_TOL
KEY_TILE = 64


def _online(qf, kf, vf, qp, tiles, window, split):
    """Online softmax of f32 scores over key tiles (index tensors), P.V
    with P as bf16 hi (+ lo when ``split``) terms: the (m, l, acc) state."""
    scale = torch.tensor(1.0 / np.sqrt(qf.shape[-1]), dtype=torch.float32)
    neg_inf = torch.tensor(float("-inf"))
    m = torch.full(qf.shape[:3] + (1,), float("-inf"))
    l = torch.zeros(qf.shape[:3] + (1,))
    acc = torch.zeros(qf.shape)
    for kp in tiles:
        kt, vt = kf[:, :, kp], vf[:, :, kp]
        ok = kp[None, :] <= qp[:, None]
        if window:
            ok &= kp[None, :] > qp[:, None] - window
        s = torch.where(ok, (qf @ kt.transpose(-1, -2)) * scale, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.where(m == neg_inf, 0.0, torch.exp(m - m_new))
        p = torch.where(m_new == neg_inf, 0.0, torch.exp(s - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        acc = acc * alpha + p_hi @ vt
        if split:
            acc = acc + (p - p_hi).to(torch.bfloat16).float() @ vt
        m = m_new
    return m, l, acc


def emulate(q, k, v, *, window, q_offset, split, key_tile=KEY_TILE, warps=1):
    """The kernel's arithmetic on (B, H, L, D) bf16 inputs: f32 scores
    from bf16 operands, online softmax over key tiles, P.V with P as
    bf16 hi (+ lo when ``split``) terms, f32 accumulation, one rounding.
    ``warps > 1`` is the decode tile: each stage of ``warps * key_tile``
    keys is split among that many warps, each with its own (m, l, acc),
    merged at the end."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qp = torch.arange(q.shape[2]) + q_offset
    lk, stage = k.shape[2], key_tile * warps
    parts = []
    for w in range(warps):
        tiles = [torch.arange(k0 + w * key_tile, min(lk, k0 + (w + 1) * key_tile))
                 for k0 in range(0, lk, stage) if k0 + w * key_tile < lk]
        parts.append(_online(q.float(), kf, vf, qp, tiles, window, split))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    lsum, out = 0.0, 0.0
    for m, l, acc in parts:
        c = torch.where(m == float("-inf"), 0.0, torch.exp(m - mx))
        lsum, out = lsum + c * l, out + c * acc
    return (out / lsum).to(torch.bfloat16)


def _inputs(b, hq, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    make = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return make(b, hq, lq, d), make(b, hkv, lk, d), make(b, hkv, lk, d)


# b, hq, hkv, lq, lk, d, window, q_offset: prefill tiles (causal, window,
# GQA, every head dim), and decode rows against a long cache
CASES = [
    (1, 4, 2, 256, 256, 64, None, 0),
    (1, 4, 2, 300, 300, 80, 128, 0),
    (1, 2, 1, 512, 512, 32, None, 0),
    (1, 8, 2, 128, 128, 16, 48, 0),
    (1, 2, 2, 200, 260, 128, None, 60),
    (4, 32, 8, 1, 1500, 80, 1024, 1499),
]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,window,q_offset", CASES)
def test_hi_lo_p_passes_the_one_ulp_gate(b, hq, hkv, lq, lk, d, window, q_offset):
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=lq + lk + d)
    want = gqa_attention_ref(q, k, v, window=window, q_offset=q_offset)
    got = emulate(q, k, v, window=window, q_offset=q_offset, split=True)
    torch.testing.assert_close(got.float(), want.float(), **GATE)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,window,q_offset", CASES)
def test_single_rounded_p_fails_the_one_ulp_gate(b, hq, hkv, lq, lk, d, window, q_offset):
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=lq + lk + d)
    want = gqa_attention_ref(q, k, v, window=window, q_offset=q_offset).float()
    got = emulate(q, k, v, window=window, q_offset=q_offset, split=False).float()
    outside = ~torch.isclose(got, want, **GATE)
    assert outside.any(), "a single bf16 rounding of P passed the one-ulp gate"
    # the values it moves past the gate are the ones near zero
    assert want[outside].abs().median() < 10 * want.abs().median()


def test_the_split_keeps_p_to_2_to_the_minus_16():
    p = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert ((p - hi).abs() <= 2.0**-8 * p).all()
    assert ((p - hi - lo).abs() <= 2.0**-16 * p).all()
    assert ((p - hi - lo).abs() < (p - hi).abs()).float().mean() > 0.99


def test_rows_without_keys_are_nan_under_the_emulation():
    q, k, v = _inputs(1, 2, 2, 6, 8, 32, seed=3)
    for kw in (dict(window=2, q_offset=10), dict(window=None, q_offset=-2)):
        want = gqa_attention_ref(q, k, v, **kw)
        got = emulate(q, k, v, split=True, **kw)
        assert torch.isnan(want).any()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        keep = ~torch.isnan(want)
        torch.testing.assert_close(got[keep].float(), want[keep].float(), **GATE)


# decode steps: at most DECODE_ROWS rows per (batch, KV head), 4 warps x 32 keys
DECODE_CASES = [
    (4, 32, 8, 1, 1500, 80, 1024, 1499),
    (2, 16, 4, 4, 300, 64, None, 296),
    (3, 8, 8, 1, 333, 16, None, 332),
]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,window,q_offset", DECODE_CASES)
def test_the_decode_tiles_warp_merge_passes_the_gate(b, hq, hkv, lq, lk, d, window, q_offset):
    assert lq * (hq // hkv) <= DECODE_ROWS
    q, k, v = _inputs(b, hq, hkv, lq, lk, d, seed=lq + lk + d)
    want = gqa_attention_ref(q, k, v, window=window, q_offset=q_offset)
    got = emulate(q, k, v, window=window, q_offset=q_offset, split=True, key_tile=32, warps=4)
    torch.testing.assert_close(got.float(), want.float(), **GATE)


def test_regime_follows_dtype_and_rows_per_kv_head():
    assert regime(torch.float32, 1) == regime(torch.float32, 10**6) == "f32"
    assert regime(torch.bfloat16, DECODE_ROWS) == "decode"
    assert regime(torch.bfloat16, DECODE_ROWS + 1) == "prefill"
    assert regime(torch.bfloat16, 4) == "decode"  # a danube decode step: 1 position x 4 heads
