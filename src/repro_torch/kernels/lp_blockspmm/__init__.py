from repro_torch.kernels.lp_blockspmm.ops import LAUNCHES, lp_round_op
from repro_torch.kernels.lp_blockspmm.ref import lp_round_ref

__all__ = ["LAUNCHES", "lp_round_op", "lp_round_ref"]
