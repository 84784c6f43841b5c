"""``collective_us_per_call``: the exchanges between ranks (``all_gather``,
``all_reduce``, ``send_recv`` of ``parallel/mesh.py``: an NCCL exchange's
enqueue, a staged one's copies through the host too), in us a call: the self
time of the ``collective.`` spans, averaged over the traced calls
(:mod:`perfbench.spanreads`).  It reads rank 0's process, the harness's own;
a program without those spans reads nothing."""

from perfbench import spanreads


def read(run):
    return spanreads.layer_us(run, "collective")
