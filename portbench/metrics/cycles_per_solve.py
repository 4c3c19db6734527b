"""cycles_per_solve: the mean V-cycles of the window's solves (``solve_loop``'s k - 1)."""


def read(run):
    reqs = run["requests"]
    return sum(r["cycles"] for r in reqs) / len(reqs) if reqs else None
