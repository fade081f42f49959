"""Operations and bytes of an LP round, and the least time they need.

Counted from the problem, not from what implements it: N rows, the
operator's nonzeros and the S label columns the round updates.  Each input
byte is read once and each output byte written once: no padding slot, no
bucket layout, and no re-read of an F row for every slot that names it.
(``repro_torch.bench.roofline.lp_round_cost``, which this replaces as the
benchmark's count, adds a gathered F row per nonzero, so its bytes are the
kernel's traffic, not the round's need.)

One round is ``Fn = c·base + A·F`` in float32:

* operations: 2 per nonzero and column (multiply and add), 2 per row and
  column for ``c·base +``, and with the residual ``max_r |Fn − F|`` 2 more
  per row and column (the difference and the running maximum);
* bytes: the operator as CSR (a 4-byte column index and a 4-byte weight
  per nonzero, a 4-byte row pointer per row), F read once, ``base`` read
  once when it is not F itself, Fn written once (and one residual per
  column).
"""

from __future__ import annotations

from typing import Dict


def lp_round(*, n: int, nnz: int, s: int, residual: bool, base_is_f: bool) -> Dict[str, float]:
    flops = 2.0 * nnz * s + 2.0 * n * s + (2.0 * n * s if residual else 0.0)
    nbytes = (
        8.0 * nnz + 4.0 * (n + 1)
        + 4.0 * n * s  # F
        + (0.0 if base_is_f else 4.0 * n * s)  # base
        + 4.0 * n * s  # Fn
        + (4.0 * s if residual else 0.0)
    )
    return {"flops": flops, "bytes": nbytes}


def least_seconds(cost: Dict[str, float], peaks: Dict[str, float]) -> Dict[str, float]:
    """The least time of ``cost`` on the card and which term sets it."""
    t_ops = cost["flops"] / peaks["flops"]
    t_bytes = cost["bytes"] / peaks["bytes_per_s"]
    return {"seconds": max(t_ops, t_bytes), "ops_s": t_ops, "bytes_s": t_bytes}
