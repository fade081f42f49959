"""dhlp-bio — the paper's own technique as a selectable arch.

The port's copy of ``repro.configs.dhlp_bio``.  A cell is one step of a
fixed-round fused DHLP-2 propagation over a COO edge list (10 rounds per
step; a driver loops steps until σ-convergence):
``F ← (β²·Y + W·F)`` cast to ``F.dtype``, with ``W[dst, src] = w``.  The
shapes are the paper's scaling points (Tables 5–6: 1M and 20M edges) plus
a 500M-edge point beyond the paper.

The step runs where its tensors are.  On CPU tensors it is the
reference's loop over ``scatter_spmm`` (:func:`lp_step_plain`).  On CUDA
tensors it builds the blocked-CSR width-bucket plan of the legacy loop
once per call, on the card from the edges already there (:func:`lp_plan`),
and runs each round as one ``csr_round`` kernel launch per bucket with
base Y and c = β² (:func:`lp_rounds`).  The plan build runs inside a
``bio.plan`` span, its three parts inside
(:func:`repro_torch.obs.profiler.hot_span`):

* ``bio.plan.download`` — the kept edges compacted, their stable sort by
  ``dst``, the degrees and the block widths on the device, and the one
  small copy of the widths, the blocks' live slots and the id bounds to
  the host;
* ``bio.plan.bucket`` — the blocks' (width, id) order, the slot scatter
  of ``src`` and ``w``, the row order and ``inv_perm``;
* ``bio.plan.upload`` — the per-bucket views and their ``LiveRows``
  (nothing is uploaded any more; the name is the benchmark's).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.cells import Cell, sds
from repro_torch.configs.registry import ArchSpec
from repro_torch.engine.autotune import DEFAULT_PARAMS
from repro_torch.engine.sparse import _bucket_round, bucket_plan
from repro_torch.graph.segment import scatter_spmm
from repro_torch.kernels.common import on_cpu
from repro_torch.obs.profiler import hot_span


@dataclasses.dataclass(frozen=True)
class DHLPBioConfig:
    name: str = "dhlp-bio"
    alpha: float = 0.5
    rounds_per_step: int = 10
    seed_chunk: int = 4096


FULL = DHLPBioConfig()
REDUCED = DHLPBioConfig(name="dhlp-bio-smoke", rounds_per_step=2, seed_chunk=8)

# |E| → (N nodes, S seed-chunk); N from the paper's edge-density model
LP_SHAPES = {
    "scale_1m": dict(num_edges=1_000_000, num_nodes=53_000, seeds=4096),
    "scale_20m": dict(num_edges=20_000_000, num_nodes=240_000, seeds=4096),
    "scale_500m": dict(num_edges=500_000_000, num_nodes=1_200_000, seeds=4096),
}
SHAPES = list(LP_SHAPES)

#: elements of one ``scatter_spmm`` message tensor (E × columns) at most in
#: :func:`lp_step_plain`; at ``scale_20m`` an unchunked one is 328 GB
PLAIN_MESSAGE_BUDGET = 1 << 30


class LPPlan(NamedTuple):
    """The width-bucket plan of a step: the legacy loop's device buckets
    ``(rows, nbr, wgt, live)`` and the inverse row permutation."""

    buckets: Tuple
    inv_perm: torch.Tensor


def lp_plan(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, num_nodes: int) -> LPPlan:
    """Bucket the COO operator for :func:`lp_rounds` where ``w`` lives
    (:func:`~repro_torch.engine.sparse.bucket_plan` at the engines' default
    layout), the weights in ``w``'s dtype.  Zero-weight edges are dropped
    (they add nothing).  Each call builds its plan from the tensors it is
    given: nothing is kept across calls."""
    with hot_span("bio.plan"):
        return LPPlan(*bucket_plan(
            src, dst, w, num_nodes,
            block_rows=DEFAULT_PARAMS.block_rows, width_mult=DEFAULT_PARAMS.width_mult,
        ))


def lp_rounds(plan: LPPlan, Y: torch.Tensor, F: torch.Tensor, cfg: DHLPBioConfig) -> torch.Tensor:
    """``cfg.rounds_per_step`` rounds ``F ← β²·Y + W·F`` over ``plan``, each
    bucket one ``csr_round`` launch (its plain version on CPU tensors),
    f32 sums rounded once to ``F.dtype``."""
    beta2 = (1.0 - cfg.alpha) ** 2
    base = Y.float()
    for _ in range(cfg.rounds_per_step):
        F = _bucket_round(plan.buckets, plan.inv_perm, F, base, beta2=beta2)
    return F


def lp_step_plain(
    cfg: DHLPBioConfig,
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    Y: torch.Tensor,
    F: torch.Tensor,
) -> torch.Tensor:
    """The reference's step: ``rounds_per_step`` times
    ``(β²·Y + scatter_spmm(src, dst, w, F)).to(F.dtype)``, the sum in f32.

    Label columns are independent: ``PLAIN_MESSAGE_BUDGET // E`` of them at
    a time give the same function with a bounded message tensor.  On
    DTensors (the dry run's sharded census) E and the columns are each
    rank's own; a step whose local columns need more than one chunk
    raises there, since a chunk of a sharded column axis is not a shard."""
    beta2 = (1.0 - cfg.alpha) ** 2
    n, s = Y.shape
    src_l, dst_l = src.long(), dst.long()

    def rounds(y, f):
        for _ in range(cfg.rounds_per_step):
            agg = _like(scatter_spmm(src_l, dst_l, w, f, n).float(), F)
            f = (beta2 * y + agg).to(F.dtype)
        return f

    e_local, s_local = _local(src).shape[0], _local(Y).shape[1]
    step = max(1, PLAIN_MESSAGE_BUDGET // max(1, e_local))
    if step >= s_local:
        return rounds(Y.float(), F)
    if hasattr(Y, "to_local"):
        raise NotImplementedError(
            f"dhlp-bio: {s_local} local seed columns over {e_local} local edges need "
            f"{-(-s_local // step)} chunks, and a chunk of a sharded column axis is not a shard")
    out = torch.empty_like(F)
    for c0 in range(0, s, step):
        out[:, c0 : c0 + step] = rounds(Y[:, c0 : c0 + step].float(),
                                        F[:, c0 : c0 + step].contiguous())
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _like(t: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """``t`` in the layout of the loop carry ``carry`` when both are
    DTensors: each round's sum over the edge shards is reduced before the
    next round gathers from it, as the reference's ``fori_loop`` carry
    keeps its sharding.  A plain tensor is returned as it is."""
    if hasattr(carry, "placements"):
        return t.redistribute(carry.device_mesh, carry.placements)
    return t


def make_lp_step(cfg: DHLPBioConfig):
    """``step(src, dst, w, Y, F)`` → F after ``cfg.rounds_per_step`` rounds:
    the plain loop on CPU tensors, :func:`lp_plan` then :func:`lp_rounds`
    (``csr_round`` launches) on CUDA tensors."""

    def step(src, dst, w, Y, F):
        if on_cpu(src, dst, w, Y, F):
            return lp_step_plain(cfg, src, dst, w, Y, F)
        return lp_rounds(lp_plan(src, dst, w, Y.shape[0]), Y, F, cfg)

    return step


def lp_cell(shape_name: str, rounds: Optional[int] = None) -> Cell:
    sh = LP_SHAPES[shape_name]
    e, n, s = sh["num_edges"], sh["num_nodes"], sh["seeds"]
    cfg = FULL if rounds is None else dataclasses.replace(FULL, rounds_per_step=rounds)
    # the reference's A/B switch: REPRO_LP_DTYPE=bf16 stores labels and edge
    # weights in bf16 (f32 sums inside each round)
    dt = torch.bfloat16 if os.environ.get("REPRO_LP_DTYPE") == "bf16" else torch.float32
    return Cell(
        arch="dhlp-bio",
        shape=shape_name,
        kind="serve",
        step_fn=make_lp_step(cfg),
        input_specs=(
            sds((e,), torch.int32),
            sds((e,), torch.int32),
            sds((e,), dt),
            sds((n, s), dt),
            sds((n, s), dt),
        ),
        donate=(4,),
        meta={"edges": e, "nodes": n, "seeds": s, "rounds": FULL.rounds_per_step,
              "scan_trip": FULL.rounds_per_step},
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dhlp-bio",
        family="lp",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lp_cell,
        make_probe_cell=lambda s, t: lp_cell(s, rounds=t),
        source="this paper (DHLP-1/2)",
    )


__all__ = [
    "DHLPBioConfig",
    "FULL",
    "LPPlan",
    "LP_SHAPES",
    "REDUCED",
    "SHAPES",
    "lp_cell",
    "lp_plan",
    "lp_rounds",
    "lp_step_plain",
    "make_lp_step",
    "spec",
]
