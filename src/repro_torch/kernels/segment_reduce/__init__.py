from repro_torch.kernels.segment_reduce.ops import (
    AGGREGATE_LAUNCHES,
    LAUNCHES,
    ROUND_LAUNCHES,
    LiveRows,
    csr_aggregate_op,
    csr_round_op,
    csr_round_residual_op,
    live_rows,
    rows_per_block,
    vector_width,
)
from repro_torch.kernels.segment_reduce.ref import (
    csr_aggregate_ref,
    csr_round_ref,
    csr_round_residual_ref,
)

__all__ = [
    "AGGREGATE_LAUNCHES",
    "LAUNCHES",
    "LiveRows",
    "ROUND_LAUNCHES",
    "csr_aggregate_op",
    "csr_aggregate_ref",
    "csr_round_op",
    "csr_round_ref",
    "csr_round_residual_op",
    "csr_round_residual_ref",
    "live_rows",
    "rows_per_block",
    "vector_width",
]
