"""``engine/sparse.py::bucket_plan``, the width-bucket plan built with
torch ops where the edges live, held bit for bit to the host builder
(``BlockedCSR.from_edges`` then ``_device_buckets``) on the CPU; the card
runs the same code (``tests/test_torch_zoo_gpu.py`` holds it there).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import dhlp_bio
from repro_torch.core.blocked_csr import BlockedCSR
from repro_torch.engine.autotune import DEFAULT_PARAMS
from repro_torch.engine.sparse import _device_buckets, bucket_plan
from repro_torch.graph.structures import powerlaw_graph

LAYOUT = dict(block_rows=DEFAULT_PARAMS.block_rows, width_mult=DEFAULT_PARAMS.width_mult)


def host_plan(src, dst, w, n, dtype=torch.float32):
    """The host builder's plan, its weights cast to ``dtype`` as the step
    used to cast them."""
    bcsr = BlockedCSR.from_edges(src.numpy(), dst.numpy(), w.float().numpy(), num_rows=n,
                                 **LAYOUT)
    buckets, inv = _device_buckets(bcsr, "cpu")
    return tuple((r, nbr, wgt.to(dtype), live) for r, nbr, wgt, live in buckets), inv


def assert_same_plan(got, want):
    (gb, gi), (wb, wi) = got, want
    assert len(gb) == len(wb)
    for (r, nbr, wgt, live), (r0, nbr0, wgt0, live0) in zip(gb, wb):
        for a, b in ((r, r0), (nbr, nbr0), (wgt, wgt0), (live.lengths, live0.lengths)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert live.slots == live0.slots and isinstance(live.slots, int)
    assert gi.dtype == wi.dtype == torch.int64 and torch.equal(gi, wi)


def _random(n, e, seed=0):
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    w = torch.as_tensor(rng.random(e) + 0.01, dtype=torch.float32)
    return src, dst, w


def _hub():
    src, dst, w = _random(500, 4_000)
    dst[:900] = 17  # row 17 far wider than any other
    return src, dst, w


def _duplicates():
    src, dst, w = _random(300, 2_000, seed=1)
    src[100:160], dst[100:160] = src[5], dst[5]  # the same (dst, src) 61 times
    return src, dst, w


def _zero_weights():
    src, dst, w = _random(300, 2_000, seed=2)
    w[::3] = 0.0
    w[1::7] = -0.0
    return src, dst, w


def _isolated():
    src, dst, w = _random(640, 1_500, seed=3)
    dst = torch.where((dst >= 64) & (dst < 256), dst + 192, dst)  # blocks 1-3 empty
    return src, dst, w


def _ragged():
    return _random(1_001, 6_000, seed=4)  # the last block holds 41 rows


def _unsorted():
    src, dst, w = _random(400, 3_000, seed=5)
    order = torch.argsort(dst, descending=True)
    return src[order], dst[order], w[order]


def _one_edge():
    return (torch.tensor([3], dtype=torch.int32), torch.tensor([70], dtype=torch.int32),
            torch.tensor([0.25]))


def _none_kept():
    src, dst, _ = _random(200, 50, seed=6)
    return src, dst, torch.zeros(50)


def _powerlaw():
    sh = dhlp_bio.LP_SHAPES["scale_1m"]
    g = powerlaw_graph(sh["num_nodes"], 50_000, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    w = torch.as_tensor(rng.random(50_000) / 8, dtype=torch.float32)
    return torch.from_numpy(g.src), torch.from_numpy(g.dst), w


CASES = {
    "hub_row": (_hub, 500),
    "duplicate_edges": (_duplicates, 300),
    "zero_weights": (_zero_weights, 300),
    "isolated_rows": (_isolated, 640),
    "n_not_a_multiple_of_64": (_ragged, 1_001),
    "dst_unsorted": (_unsorted, 400),
    "one_edge": (_one_edge, 100),
    "no_kept_edge": (_none_kept, 200),
    "bf16_through_lp_plan": (_random, 700),
    "powerlaw_scale_1m_law_50k_edges": (_powerlaw, dhlp_bio.LP_SHAPES["scale_1m"]["num_nodes"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bucket_plan_is_the_host_plan_bit_for_bit(case):
    make, n = CASES[case]
    if case == "bf16_through_lp_plan":
        src, dst, w = make(n, 5_000, 8)
        w = w.to(torch.bfloat16)
        got = dhlp_bio.lp_plan(src, dst, w, n)
        assert_same_plan(got, host_plan(src, dst, w, n, torch.bfloat16))
        return
    src, dst, w = make()
    assert_same_plan(bucket_plan(src, dst, w, n, **LAYOUT), host_plan(src, dst, w, n))
    assert_same_plan(dhlp_bio.lp_plan(src, dst, w, n), host_plan(src, dst, w, n))


@pytest.mark.parametrize("which, bad", [("src", -1), ("src", 300), ("dst", -2), ("dst", 301)])
def test_bucket_plan_refuses_an_id_out_of_range(which, bad):
    src, dst, w = _random(300, 1_000, seed=9)
    (src if which == "src" else dst)[123] = bad
    with pytest.raises(ValueError):
        bucket_plan(src, dst, w, 300, **LAYOUT)
    w[123] = 0.0  # a dropped edge is not checked, as the host builder does not
    assert_same_plan(bucket_plan(src, dst, w, 300, **LAYOUT), host_plan(src, dst, w, 300))


def test_lp_plan_keeps_nothing_across_calls():
    """Two calls on the same tensors, ``w`` changed in place between them:
    the second plan carries the second weights."""
    src, dst, w = _random(300, 2_000, seed=10)
    first = dhlp_bio.lp_plan(src, dst, w, 300)
    want_first = host_plan(src, dst, w, 300)
    w.mul_(3.0)
    w[::5] = 0.0
    second = dhlp_bio.lp_plan(src, dst, w, 300)
    assert_same_plan(first, want_first)
    assert_same_plan(second, host_plan(src, dst, w, 300))
