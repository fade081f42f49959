"""solve.rounds: the solver's rounds to σ, from each solve's ``SolveResult``
(``outer_iters``), averaged over the window's solves.  Moves ``solve_s``:
every round is a pass over the operator and a host sync."""


def read(ctx):
    rounds = ctx.counters.get("solve.rounds")
    return sum(rounds) / len(rounds) if rounds else None
