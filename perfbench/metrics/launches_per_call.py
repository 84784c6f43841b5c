"""``launches_per_call``: the device kernel records of the traced part of the
window (``torch.profiler``), every kernel and not only the port's own,
divided by the calls made in it.  Copies and fills are not counted."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not tr.calls:
        return None
    return len(tr.kernels) / tr.calls
