"""``setup_build_s``: the seconds of the set-up span ``setup.kernel_build``,
the first load of the hand kernels' library: the ``nvcc`` probe, a build
where the library is missing, and the ``dlopen``."""

from perfbench import spanreads


def read(run):
    return spanreads.setup_seconds(run, "setup.kernel_build")
