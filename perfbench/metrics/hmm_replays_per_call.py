"""``hmm_replays_per_call``: the HMM's VMP fits run from a captured CUDA
graph, a call (the ``model.hmm.graph.replays`` counter's increment during the
call), averaged over the traced calls (:mod:`perfbench.spanreads`).  A
program without that counter reads nothing."""

from perfbench import spanreads


def read(run):
    calls = spanreads.traced_calls(run)
    if not calls:
        return None
    from cortex_tpu_torch.utils import spans

    if "model.hmm.graph.replays" not in spans.counts():
        return None
    return sum(r.counts.get("model.hmm.graph.replays", 0) for r in calls) / len(calls)
