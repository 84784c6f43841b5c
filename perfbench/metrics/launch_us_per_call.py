"""``launch_us_per_call``: the hand kernels' CUDA implementations: preparation
and the launch, in us a call: the self time of the ``launch.`` spans,
averaged over the traced calls (:mod:`perfbench.spanreads`)."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "launch")
