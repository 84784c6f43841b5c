"""``k4_roofline``: K4's least time for one chunk of the stream
(:func:`perfbench.costs_hgf.k4` at the traffic's replicas, the
configuration's chunk and its tracks, float32, from a given state, over the
card's peaks) over its mean device time in the traced window
(``torch.profiler``).  K4's records are the kernels of
``csrc/hgf_filter.cu``; none in the trace, no value."""

import re

from perfbench import costs_hgf, peaks

K4 = re.compile(r"\bhgf_filter_kernel\b")


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds(K4.search)
    if not times:
        return None
    cfg = run.cell.config
    least = peaks.least_seconds(*costs_hgf.k4(int(run.cell.traffic["replicas"]), int(cfg["chunk"]),
                                              len(cfg["tracks"]), True))
    return 100.0 * least / (sum(times) / len(times))
