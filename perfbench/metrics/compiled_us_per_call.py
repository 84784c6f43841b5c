"""``compiled_us_per_call``: the compiled path's executor: gathers, write-backs
and the sweep's loop, in us a call: the self time of the ``compiled.``
spans, averaged over the traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "compiled")
