"""k1_roofline: kernel K1's share of its roofline, in %: the least time of
one operator apply at the lattice's (N, D, k) (`peaks.k1_bound`) over K1's
device time per launch in the traced window (``spmv_gather_kernel``).
Against the published peaks at 700 W; the result's ``device`` carries the
card's power limit."""

from portbench.peaks import k1_bound


def read(run):
    t = run.trace
    if not t or not t["k1_launches"]:
        return None
    c = run.config
    n = c["corpus"]["n"]
    bound = k1_bound(n, c["corpus"]["d"], min(c["kneighbors"], n - 1))["seconds"]
    return 100.0 * bound / (t["k1_s"] / t["k1_launches"])
