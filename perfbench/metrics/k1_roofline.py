"""``k1_roofline``: K1's least time (:func:`perfbench.costs.k1` at the
traffic's replicas and the configuration's steps, over the card's peaks) over
its mean device time in the traced window (``torch.profiler``).  K1's records
are the kernels of ``csrc/lgssm_smooth.cu``; none in the trace, no value."""

import re

from perfbench import costs, peaks

K1 = re.compile(r"\bsmooth_(segments|global)_kernel\b")


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds(K1.search)
    if not times:
        return None
    least = peaks.least_seconds(*costs.k1(int(run.cell.traffic["replicas"]),
                                          int(run.cell.config["T"])))
    return 100.0 * least / (sum(times) / len(times))
