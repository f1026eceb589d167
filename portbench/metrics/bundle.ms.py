"""bundle.ms: a harness span around ``bundle()`` less the U* solve it ran
(``last_ustar["solve_ms"]``; none where it reuses the cached U*): the
bundle's own work (the coherence-drop scores' edge-distance passes, the z
and alignment, the MMR picks and their host reads), mean over the
window's bundles."""

import statistics


def read(run):
    ms = run.counters.get("bundle_ms")
    return statistics.fmean(ms) if ms else None
