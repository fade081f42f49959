"""Hand-written Hopper kernels, each beside its plain PyTorch version.

=====================  ==========================================  ====================
kernel                 replaces (Pallas TPU kernel)                 source
=====================  ==========================================  ====================
csr_round_residual     repro/kernels/segment_reduce/kernel.py       csrc/csr_round_residual.cu
csr_round              repro/kernels/segment_reduce/kernel.py       csrc/csr_round.cu
lp_round               repro/kernels/lp_blockspmm/kernel.py         csrc/lp_round.cu
=====================  ==========================================  ====================

Each ``*_op`` wrapper takes the plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); each kernel launch adds one to
the wrapper's :class:`~repro_torch.kernels.common.LaunchCounter`.
"""

from repro_torch.kernels import lp_blockspmm, segment_reduce
from repro_torch.kernels.lp_blockspmm import lp_round_op, lp_round_ref
from repro_torch.kernels.segment_reduce import (
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
    )
}
#: every kernel's CUDA source under ``csrc/``
SOURCES = (
    segment_reduce.ops.SOURCE,
    segment_reduce.ops.ROUND_SOURCE,
    lp_blockspmm.ops.SOURCE,
)


def launch_counts() -> dict:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = [
    "COUNTERS",
    "SOURCES",
    "csr_round_op",
    "csr_round_ref",
    "csr_round_residual_op",
    "csr_round_residual_ref",
    "launch_counts",
    "lp_round_op",
    "lp_round_ref",
    "reset_launch_counts",
]
