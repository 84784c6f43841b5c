"""``stream_us_per_call``: the streaming layer's own work around the model's
calls on each chunk, in us a call: the self time of the ``stream.`` spans
(the root ``stream.filter``, each chunk's ``stream.stage`` and
``stream.wait``), averaged over the traced calls
(:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "stream")
