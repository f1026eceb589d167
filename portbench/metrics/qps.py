"""qps: queries (service requests) completed in the window over the
window's seconds, the window running from its first call to the end of its
last query."""


def read(run):
    done = sum(x is not None for x in run.latencies)
    return done / run.window_s if run.window_s > 0 and done else None
