"""solve_ms: the window's wall time over the solves completed in it."""


def read(run):
    done = sum(1 for r in run.records if not r.error)
    return 1e3 * run.wall_s / done if done else None
