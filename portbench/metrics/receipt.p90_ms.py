"""receipt.p90_ms: the 90th percentile (nearest rank) of ``receipt()``'s
host time over the window's queries, a harness span: the tail of the
gating query's largest part, which a window of the benchmark's length
holds too few queries to bound end to end."""

from portbench.harness import nearest_rank


def read(run):
    spans = run.spans.get("receipt")
    return 1e3 * nearest_rank(spans, 0.9) if spans else None
