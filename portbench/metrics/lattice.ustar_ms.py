"""lattice.ustar_ms: mean of the U* solve's milliseconds as the lattice
records them (``last_ustar["solve_ms"]``, its host clock up to the CG's
last host read), over the window's solves."""

import statistics


def read(run):
    ms = run.counters.get("ustar_solve_ms")
    return statistics.fmean(ms) if ms else None
