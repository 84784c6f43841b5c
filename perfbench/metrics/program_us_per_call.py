"""``program_us_per_call``: a call of the entry point as the program times it,
from its root span opening to its closing (``model.lgssm.smooth``,
``model.hmm.fit_vmp``, ``compiled.run``), in us, averaged over the traced
calls (:mod:`perfbench.spanreads`); the layer metrics of the cell add up to
it."""

from perfbench import spanreads


def read(run):
    calls = spanreads.traced_calls(run)
    if not calls:
        return None
    return sum(r.end_ns - r.start_ns for r in calls) / len(calls) / 1e3
