"""Kernel micro-benchmarks: the reference's four cases (``lp_round``,
``csr_aggregate``, ``embedding_bag``, causal ``attention``) at its fast
and full sizes, on the same numpy inputs (seed 0).

Each case gets a ``torch_ref`` record: the plain PyTorch version, the
counterpart of the reference's jnp-oracle column.  On a card each case
also gets a ``cuda`` record: the hand-written kernel (B2 ``lp_round``,
B4 ``csr_aggregate``, B5 ``embedding_bag``, B6 ``flash_attention``),
timed like the plain version with CUDA events around many launches,
each after an L2 flush (the inputs come from HBM, not L2), and carrying
a strict ``agree_ref`` — 1.0 when the kernel is within the f32 tolerance
(``rtol=2e-4, atol=5e-4``, ``tests/test_kernels.py::_tol``) of its plain
version on the same inputs.  On the CPU the plain versions are
timed on the host clock and there is no ``cuda`` record.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from repro_torch.bench.registry import register_suite
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import (
    TimingStats,
    derived_throughput,
    time_callable,
    time_cuda_events,
)

#: the kernels' f32 tolerance against their plain versions
F32_TOL = dict(rtol=2e-4, atol=5e-4)
# sub-ms kernels: enough repeats that the compared median sits below the
# noise tail
REPEATS = 7


def _cases(fast: bool, rng, dev) -> List[Dict[str, object]]:
    """The four cases: name, params, inputs, plain version, kernel, and
    the throughput counts of one call."""
    import torch

    from repro_torch.kernels import (
        attention_ref,
        csr_aggregate_op,
        csr_aggregate_ref,
        embedding_bag_op,
        embedding_bag_ref,
        flash_attention_op,
        lp_round_op,
        lp_round_ref,
    )

    def t(a):
        return torch.as_tensor(a, device=dev)

    cases = []
    n, s = (512, 256) if fast else (2048, 1024)
    A = t(rng.random((n, n)).astype(np.float32)) / n
    F = t(rng.random((n, s)).astype(np.float32))
    base = t(rng.random((n, s)).astype(np.float32))
    cases.append(dict(
        name=f"lp_round_{n}x{s}", params={"n": n, "s": s},
        plain=lambda: lp_round_ref(A, F, base, 0.25),
        kernel=lambda: lp_round_op(A, F, base, c=0.25),
        counts={"flops": 2 * n * n * s},
    ))

    nbr = t(rng.integers(0, n, (n, 16)).astype(np.int32))
    wgt = t(rng.random((n, 16)).astype(np.float32))
    cases.append(dict(
        name=f"csr_aggregate_{n}x16", params={"n": n, "deg": 16},
        plain=lambda: csr_aggregate_ref(nbr, wgt, F),
        kernel=lambda: csr_aggregate_op(nbr, wgt, F),
        counts={"edges": n * 16},
    ))

    v, dd, b, k = (50_000, 32, 4096, 8) if fast else (500_000, 32, 65_536, 8)
    tab = t(rng.random((v, dd)).astype(np.float32))
    idx = t(rng.integers(0, v, (b, k)).astype(np.int32))
    w = t(rng.random((b, k)).astype(np.float32))
    cases.append(dict(
        name=f"embedding_bag_b{b}", params={"vocab": v, "dim": dd, "batch": b, "k": k},
        plain=lambda: embedding_bag_ref(tab, idx, w),
        kernel=lambda: embedding_bag_op(tab, idx, w),
        counts={"lookups": b * k},
    ))

    bq, lq, hd = (2, 256, 64) if fast else (4, 1024, 64)
    q = t(rng.standard_normal((bq, 4, lq, hd)).astype(np.float32))
    kk = t(rng.standard_normal((bq, 4, lq, hd)).astype(np.float32))
    vv = t(rng.standard_normal((bq, 4, lq, hd)).astype(np.float32))
    cases.append(dict(
        name=f"attention_l{lq}", params={"batch": bq, "heads": 4, "len": lq, "hd": hd},
        plain=lambda: attention_ref(q, kk, vv, causal=True),
        kernel=lambda: flash_attention_op(q, kk, vv, causal=True),
        counts={"tokens": bq * lq},
    ))
    return cases


def _derived(stats: TimingStats, counts: Dict[str, int]) -> Dict[str, float]:
    t = max(stats.median_s, 1e-12)
    if "flops" in counts:
        return derived_throughput(stats, flops=counts["flops"])
    if "edges" in counts:
        return derived_throughput(stats, edges=counts["edges"])
    if "lookups" in counts:
        return {"lookups_per_s": counts["lookups"] / t}
    return {"tok_per_s": counts["tokens"] / t}


@register_suite("kernels", description="hand kernels vs their plain versions")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)

    def timed(fn: Callable[[], object]) -> TimingStats:
        if on_card:
            return time_cuda_events(fn, dev, warmup=2, iters=10, repeats=REPEATS)
        return time_callable(fn, warmup=1, repeats=REPEATS)

    out: List[BenchRecord] = []
    for case in _cases(fast, rng, dev):
        ref_stats = timed(case["plain"])
        out.append(BenchRecord(
            suite="kernels", name=case["name"], backend="torch_ref",
            params=dict(case["params"]), stats=ref_stats.to_dict(),
            derived=_derived(ref_stats, case["counts"]),
        ))
        if not on_card:
            continue
        want = case["plain"]()
        got = case["kernel"]()
        diff = float((got - want).abs().max())
        agree = bool(torch.allclose(got, want, **F32_TOL))
        stats = timed(case["kernel"])
        derived = _derived(stats, case["counts"])
        derived.update({
            "agree_ref": 1.0 if agree else 0.0,
            "max_abs_diff_vs_ref": diff,
            "speedup_vs_ref": ref_stats.median_s / max(stats.median_s, 1e-12),
        })
        out.append(BenchRecord(
            suite="kernels", name=case["name"], backend="cuda",
            params=dict(case["params"]), stats=stats.to_dict(),
            derived=derived, strict=["agree_ref"],
        ))
    return out
