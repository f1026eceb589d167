"""large.build_ms: the milliseconds of the port's ``service.build`` span
(``service/api.py`` ``_build_lattice``: the request's lattice, with Y to
the card, its hash, the graph build's top-k and ``graph_from_topk`` and
the edge count's host read), mean a request, over the requests recorded
(``systems/service_spans.py``); nothing where the program records no
such span."""

import statistics


def read(run):
    ms = run.counters.get("large_build_ms")
    return statistics.fmean(ms) if ms else None
