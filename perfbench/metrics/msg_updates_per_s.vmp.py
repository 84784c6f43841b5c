"""``msg_updates_per_s.vmp``: ``msg_updates_per_s`` of the VMP fit's cell,
read in its traced run from the untraced part of the window (host clock).
The fit's pace is the host's Python loop, whose speed drifts by 10-20% over
seconds on a shared host, too widely for any bound: its cell's end-to-end
metric is ``call_p95_ms``, and this rate stands beside it per layer."""


def read(run):
    w = run.window
    return w.calls * run.entry.updates_per_call / w.seconds if w.calls else None
