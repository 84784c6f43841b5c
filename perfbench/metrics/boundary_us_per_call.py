"""``boundary_us_per_call``: the entry points' conversion and checks of their
inputs, in us a call: the self time of the ``boundary.`` spans, averaged
over the traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "boundary")
