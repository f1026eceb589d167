"""receipt.ms: a harness span around ``receipt()`` less the U* solve it
ran (``last_ustar["solve_ms"]``): the receipt's own work (dH, the per-node
sums, the null points and their listing on the host), mean over the
window's receipts."""

import statistics


def read(run):
    ms = run.counters.get("receipt_ms")
    return statistics.fmean(ms) if ms else None
