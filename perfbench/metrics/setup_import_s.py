"""``setup_import_s``: the seconds of the set-up span ``setup.import``, the
port's subpackages' imports (``import torch`` itself excluded)."""

from perfbench import spanreads


def read(run):
    return spanreads.setup_seconds(run, "setup.import")
