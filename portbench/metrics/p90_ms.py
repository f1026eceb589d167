"""p90_ms: the 90th percentile (nearest rank) of the host-clock latency of
every query issued in the window; a failed query counts as infinite."""

import math

from portbench.harness import nearest_rank


def read(run):
    if not run.latencies:
        return None
    lat = [math.inf if x is None else x for x in run.latencies]
    return 1e3 * nearest_rank(lat, 0.9)
