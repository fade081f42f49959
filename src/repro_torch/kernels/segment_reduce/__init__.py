from repro_torch.kernels.segment_reduce.ops import (
    LAUNCHES,
    csr_round_residual_op,
    rows_per_block,
)
from repro_torch.kernels.segment_reduce.ref import (
    csr_aggregate_ref,
    csr_round_residual_ref,
)

__all__ = [
    "LAUNCHES",
    "csr_aggregate_ref",
    "csr_round_residual_op",
    "csr_round_residual_ref",
    "rows_per_block",
]
