"""solver.ms_per_iter: the U* solve's milliseconds over its CG iterations
(``last_ustar``), averaged over the window's solves."""

import statistics


def read(run):
    ms, its = run.counters.get("ustar_solve_ms"), run.counters.get("ustar_iters")
    if not ms:
        return None
    return statistics.fmean(m / max(1, i) for m, i in zip(ms, its))
