"""batch.bundle_ms: the port's ``lattice.bundle_batch`` span less its
``lattice.ustar_batch``, mean a call, over the calls recorded: the lanes'
bundle scores, their MMR picks and the host reads of picks, scores and
alignments; nothing where the program records no such spans."""

import statistics


def read(run):
    ms = run.counters.get("batch_bundle_ms")
    return statistics.fmean(ms) if ms else None
