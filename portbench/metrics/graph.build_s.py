"""graph.build_s: the lattice's construction in set-up (the mutual-kNN
graph build of ops/graph.py), a harness span on the host clock ending in a
device synchronise."""


def read(run):
    return run.setup_spans.get("graph.build")
