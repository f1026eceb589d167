"""ivf.kmeans_s: the seconds of the port's ``ivf.kmeans`` span in set-up
(``ops/ivf.py`` ``ivf_topk``: the Lloyd loop, the balance rounds, the
bucketing and the probe sets, ending at the overflow count's host read),
as the graph build records it under the span recorder
(``systems/lattice_ivf.py``); nothing where the build ran no such span."""


def read(run):
    return run.setup_spans.get("ivf.kmeans")
