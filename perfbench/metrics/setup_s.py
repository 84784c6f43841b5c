"""``setup_s``: from the start of the run's script to the start of its
window: imports, the kernels' build or load, the ring of inputs, the entry
(a compiled program's build) and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
