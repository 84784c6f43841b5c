"""``collective_bytes_per_call``: the bytes that rank 0 sends in the mesh's
exchanges a call (the ``collective.bytes`` counter's increment during the
call, the number ``CollectiveStats`` counts), averaged over the traced calls
(:mod:`perfbench.spanreads`).  It reads rank 0's process, the harness's
own; a program without that counter reads nothing."""

from perfbench import spanreads


def read(run):
    calls = spanreads.traced_calls(run)
    if not calls:
        return None
    from cortex_tpu_torch.utils import spans

    if "collective.bytes" not in spans.counts():
        return None
    return sum(r.counts.get("collective.bytes", 0) for r in calls) / len(calls)
