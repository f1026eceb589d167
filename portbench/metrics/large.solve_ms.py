"""large.solve_ms: the milliseconds of the port's ``service.settle`` and
``service.bundle`` spans (``service/api.py`` ``h_bundle``: the lattice's
settle, then its bundle with the U* solve, the scores and the MMR picks),
summed a request and averaged over the requests recorded
(``systems/service_spans.py``); nothing where the program records no
such spans."""

import statistics


def read(run):
    ms = run.counters.get("large_solve_ms")
    return statistics.fmean(ms) if ms else None
