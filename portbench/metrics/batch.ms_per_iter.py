"""batch.ms_per_iter: a call's ``lattice.ustar_batch`` milliseconds over
its solve's loop trip count (``last_ustar_batch["loop_iters"]``, the
largest lane's iterations), averaged over the calls recorded; nothing
where the program records no such span or count."""

import statistics


def read(run):
    ms = run.counters.get("batch_ms_per_iter")
    return statistics.fmean(ms) if ms else None
