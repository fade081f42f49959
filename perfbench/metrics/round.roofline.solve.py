"""round.roofline.solve: the least time of the window's solve rounds on the
card over the device kernel time inside the solves, in per cent.

The least time is counted from the problem (``perfbench/harness/roofline.py``):
each round over the columns still active in it (a column's round count is
its ``SolveResult.per_column_iters``), N rows and the operator's nonzeros,
each input byte once.  The kernel time is that of every kernel that starts
inside a ``solve`` range, whatever kernels run the rounds.  Moves
``solve_s``."""

import numpy as np

from perfbench.harness import roofline


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or ctx.peaks is None or "solve.column_rounds" not in c:
        return None
    kernel_s = ctx.trace.kernel_seconds_in("solve")
    if kernel_s <= 0:
        return None
    least = 0.0
    for cols in c["solve.column_rounds"]:
        cols = np.asarray(cols)
        for k in range(1, int(cols.max(initial=0)) + 1):
            cost = roofline.lp_round(n=c["solve.n"], nnz=c["solve.nnz"], s=int((cols >= k).sum()),
                                     residual=True, base_is_f=c["solve.base_is_f"])
            least += roofline.least_seconds(cost, ctx.peaks)["seconds"]
    return 100.0 * least / kernel_s
