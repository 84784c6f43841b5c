"""``model_us_per_call``: the model's own Python and tensor work around the
operations it calls, in us a call: the self time of the ``model.`` spans,
averaged over the traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "model")
