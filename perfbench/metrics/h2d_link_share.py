"""``h2d_link_share``: the host-to-card link's least time for a call's
observations (the traffic's replicas times the configuration's steps, float32,
at :data:`LINK_BYTES_PER_S`) over the device seconds of the traced window's
``Memcpy HtoD`` records a traced call (``torch.profiler``).  No such record
in the trace, no value."""

# PCIe Gen5 x16, one direction: 32 GT/s a lane x 16 lanes, 64 GB/s before the
# protocol's overheads (PCI-SIG, PCI Express Base Specification 5.0; the H100
# SXM's host link, NVIDIA's H100 data sheet).  Frozen here.
LINK_BYTES_PER_S = 64e9
F32 = 4


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    copy_s = sum(s for name, s in tr.copies if name.startswith("Memcpy HtoD"))
    if not copy_s:
        return None
    nbytes = F32 * int(run.cell.traffic["replicas"]) * int(run.cell.config["T"])
    return 100.0 * (nbytes / LINK_BYTES_PER_S) / (copy_s / tr.calls)
