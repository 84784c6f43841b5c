"""``host_us_per_call``: the benchmark's own span around the entry call, from
just before it until it returns (the enqueue, not the wait), averaged over
the calls of the untraced part of the window (host clock)."""


def read(run):
    host = run.window.host_s
    return sum(host) / len(host) * 1e6 if host else None
