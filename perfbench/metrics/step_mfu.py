"""``step_mfu``: the whole call's least time on the card (the larger of its
operations over the float32 peak and its bytes over the HBM bandwidth,
counted from its shapes by :mod:`perfbench.costs`) over the measured time a
call, the untraced window's seconds over its calls (host clock)."""

from perfbench import peaks


def read(run):
    w = run.window
    if not w.calls:
        return None
    return 100.0 * peaks.least_seconds(*run.entry.cost) / (w.seconds / w.calls)
