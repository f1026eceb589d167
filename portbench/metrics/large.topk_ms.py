"""large.topk_ms: the milliseconds of the port's ``graph.topk`` span
(``ops/graph.py`` ``build_graph``: the top-k scan, one [N, N] product up
to the dense limit of 4096 rows, 1024-row blocks above it), mean a
request, over the requests recorded (``systems/service_spans.py``);
nothing where the program records no such span."""

import statistics


def read(run):
    ms = run.counters.get("large_topk_ms")
    return statistics.fmean(ms) if ms else None
