"""``msg_updates_per_s``: every message update completed in the window over
the window's seconds (host clock).  A forward-backward pass over R replicas
of T steps is R (3T - 2) updates; the entry counts its passes a call."""


def read(run):
    w = run.window
    return w.calls * run.entry.updates_per_call / w.seconds if w.calls else None
