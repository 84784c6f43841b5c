"""``h2d_copies_per_call``: the program's uploads to the card a call (its
``copy.h2d.calls`` counter's increment during the call), averaged over the
traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    calls = spanreads.traced_calls(run)
    if not calls:
        return None
    return sum(r.counts.get("copy.h2d.calls", 0) for r in calls) / len(calls)
