"""``k3_roofline``: K3's least time (:func:`perfbench.costs.k3` at the
traffic's replicas and the configuration's steps and states, over the card's
peaks) over its mean device time in the traced window (``torch.profiler``).
K3's records are the kernels of ``csrc/hmm_forward_backward.cu`` built with
the counts (template flag ``COUNTS`` true); none in the trace, no value."""

import re

from perfbench import costs, peaks

K3 = re.compile(r"\bfb_(pair_kernel<\d+, true>|small_kernel<\d+, true, (true|false)>"
                r"|general_kernel<true, (true|false)>)")


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds(K3.search)
    if not times:
        return None
    cfg = run.cell.config
    least = peaks.least_seconds(*costs.k3(int(run.cell.traffic["replicas"]), int(cfg["T"]),
                                          int(cfg["K"])))
    return 100.0 * least / (sum(times) / len(times))
