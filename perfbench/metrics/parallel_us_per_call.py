"""``parallel_us_per_call``: the parallel layer's own work on the rank's block
(the time-sharded smoother's element builds, local scans and folds, enqueued
on the card), in us a call: the self time of the ``parallel.`` spans,
averaged over the traced calls (:mod:`perfbench.spanreads`).  It reads rank
0's process, the harness's own; a program without those spans reads
nothing."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "parallel")
