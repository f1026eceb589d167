"""batch.ustar_ms: the milliseconds of the port's ``lattice.ustar_batch``
span (``core/lattice.py`` ``_solve_batch_device``: the lanes CG solve of
the whole batch, the interval of ``last_ustar_batch["solve_ms"]``), mean
a call, over the calls recorded (``systems/lattice_batch.py``); nothing
where the program records no such span."""

import statistics


def read(run):
    ms = run.counters.get("batch_ustar_ms")
    return statistics.fmean(ms) if ms else None
