"""``graph_replays_per_call``: the compiled path's sweeps run from a captured
CUDA graph, a call (the ``compiled.graph.replays`` counter's increment during
the call), averaged over the traced calls (:mod:`perfbench.spanreads`).  A
program without that counter reads nothing."""

from perfbench import spanreads


def read(run):
    calls = spanreads.traced_calls(run)
    if not calls:
        return None
    from cortex_tpu_torch.utils import spans

    if "compiled.graph.replays" not in spans.counts():
        return None
    return sum(r.counts.get("compiled.graph.replays", 0) for r in calls) / len(calls)
