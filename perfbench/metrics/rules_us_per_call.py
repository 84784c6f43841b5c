"""``rules_us_per_call``: the compiled path's batched rules, in us a call: the
self time of the ``rules.`` spans, averaged over the traced calls
(:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "rules")
