"""``ops_us_per_call``: the message-passing operations: their wrappers and the
operators' dispatch, in us a call: the self time of the ``ops.`` spans,
averaged over the traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "ops")
