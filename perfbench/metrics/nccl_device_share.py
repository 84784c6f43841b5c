"""``nccl_device_share``: the NCCL kernels' device time (every kernel whose
name starts with ``nccl``) over the device's busy time, in the device-only
traced part of the window (``torch.profiler``), in %.  An NCCL kernel runs
from its launch until every rank of its group has joined, so this share
holds the exchange itself and the wait for the slowest rank: where it is
small, the exchange is hidden behind the ranks' own work.  It reads rank 0's
process and card, the harness's own; a trace with no NCCL kernel reads
nothing."""


def read(run):
    tr = run.trace
    if tr is None or not tr.busy_s:
        return None
    times = tr.kernel_seconds(lambda name: name.startswith("nccl"))
    if not times:
        return None
    return 100.0 * sum(times) / tr.busy_s
