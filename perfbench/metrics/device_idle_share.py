"""``device_idle_share``: the share of the device-only traced part of the
window (``torch.profiler``, CUDA activity alone) in which no device record
(kernel, copy or fill) runs: ``1 - busy_s / window_s`` of the result line's
``device``.  The run's notes give that part's pace of calls beside the
untraced window's, so the profiler's cost to the host is in view."""


def read(run):
    tr = run.trace
    if tr is None or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
