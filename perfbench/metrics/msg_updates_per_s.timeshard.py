"""``msg_updates_per_s.timeshard``: ``msg_updates_per_s`` of the time-sharded
cell, read in its traced run from the untraced part of the window (host
clock, rank 0's process): every message update of the whole chain, R (3T -
2) a call with the global T, completed over the part's seconds.  Its cell's
end-to-end metric is ``call_p95_ms``; this rate stands beside it per
layer."""


def read(run):
    w = run.window
    return w.calls * run.entry.updates_per_call / w.seconds if w.calls else None
