"""What the readers of the program's own spans and counters read:
``cortex_tpu_torch.utils.spans``, whose spans time into memory only inside a
``torch.profiler`` session, so only in the traced parts of a ``--trace 1``
run.  A program without that module reads nothing (``None``).

The traced parts' calls are the first ``run.trace.calls`` call records of
the process, those of the device-only part, where the spans record there;
where they record only under the host's activity, every record the process
holds is one of the labelled part's calls, and those are read.

Only a run whose traced part holds device records is read: on a host
without a card the calls run the operators' plain versions, whose layers
are not those of the path the cells measure.
"""

from __future__ import annotations


def _spans():
    try:
        from cortex_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _on_device(run) -> bool:
    return run.trace is not None and run.trace.busy_s > 0


def traced_calls(run) -> list:
    """The call records of the traced part that the readers read."""
    spans = _spans()
    if spans is None or not _on_device(run):
        return []
    return [r for r in spans.calls() if r.id < run.trace.calls]


def layer_us(run, layer: str):
    """The self time of ``layer`` a call, in us, averaged over the traced
    calls; ``None`` where no call has that layer."""
    calls = traced_calls(run)
    if not any(layer in r.layers for r in calls):
        return None
    return sum(r.layers.get(layer, 0) for r in calls) / len(calls) / 1e3


def setup_seconds(run, name: str):
    """The seconds of the set-up span ``name`` in this process, or ``None``."""
    spans = _spans()
    return None if spans is None or not _on_device(run) else spans.setup().get(name)
