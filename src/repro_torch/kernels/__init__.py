"""Hand-written Hopper kernels, each beside its plain PyTorch version.

=====================  ==========================================  ====================
kernel                 replaces (Pallas TPU kernel)                 source
=====================  ==========================================  ====================
csr_round_residual     repro/kernels/segment_reduce/kernel.py       csrc/csr_round_residual.cu
csr_round              repro/kernels/segment_reduce/kernel.py       csrc/csr_round.cu
lp_round               repro/kernels/lp_blockspmm/kernel.py         csrc/lp_round.cu
csr_aggregate          repro/kernels/segment_reduce/kernel.py       csrc/csr_aggregate.cu
csr_aggregate (bwd)    none: B4 on the transposed operator          csrc/csr_aggregate.cu
embedding_bag          repro/kernels/embedding_bag/kernel.py        csrc/embedding_bag.cu
flash_attention        repro/kernels/flash_attention/kernel.py      csrc/flash_attention.cu
=====================  ==========================================  ====================

Each ``*_op`` wrapper takes the plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); each kernel launch adds one to
the wrapper's :class:`~repro_torch.kernels.common.LaunchCounter`
(``csr_aggregate_backward`` counts B4's launches by
:class:`~repro_torch.kernels.segment_reduce.CSRAggregate`'s backward).
"""

from repro_torch.kernels import embedding_bag, flash_attention, lp_blockspmm, segment_reduce
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_ref
from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention_op,
    gqa_attention_op,
)
from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
from repro_torch.kernels.segment_reduce import (
    csr_aggregate_op,
    csr_aggregate_ref,
    csr_round_op,
    csr_round_ref,
    csr_round_residual_op,
    csr_round_residual_ref,
)

#: every kernel's launch counter, by kernel name
COUNTERS = {
    c.name: c
    for c in (
        segment_reduce.LAUNCHES,
        segment_reduce.ROUND_LAUNCHES,
        lp_blockspmm.LAUNCHES,
        segment_reduce.AGGREGATE_LAUNCHES,
        segment_reduce.AGGREGATE_BACKWARD_LAUNCHES,
        embedding_bag.LAUNCHES,
        flash_attention.LAUNCHES,
    )
}
#: every kernel's CUDA source under ``csrc/``
SOURCES = (
    segment_reduce.ops.SOURCE,
    segment_reduce.ops.ROUND_SOURCE,
    lp_blockspmm.ops.SOURCE,
    segment_reduce.ops.AGGREGATE_SOURCE,
    embedding_bag.ops.SOURCE,
    flash_attention.ops.SOURCE,
)


def launch_counts() -> dict:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = [
    "COUNTERS",
    "SOURCES",
    "attention_ref",
    "csr_aggregate_op",
    "csr_aggregate_ref",
    "csr_round_op",
    "csr_round_ref",
    "csr_round_residual_op",
    "csr_round_residual_ref",
    "embedding_bag_op",
    "embedding_bag_ref",
    "flash_attention_op",
    "gqa_attention_op",
    "launch_counts",
    "lp_round_op",
    "lp_round_ref",
    "reset_launch_counts",
]
