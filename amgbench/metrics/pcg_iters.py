"""pcg_iters.<solve|step>: the mean of SolveResult.iters over the traced
requests (a counter of the program)."""


def read(run):
    it = [r.iters for r in run.traced if not r.error]
    return sum(it) / len(it) if it else None
