"""ivf.scan_s: the seconds of the port's ``ivf.scan`` span in set-up
(``ops/ivf.py`` ``ivf_topk``: the per-cluster ``bmm`` groups and the
patch scan, ending after the patch rows' host read), as the graph build
records it under the span recorder (``systems/lattice_ivf.py``); nothing
where the build ran no such span."""


def read(run):
    return run.setup_spans.get("ivf.scan")
