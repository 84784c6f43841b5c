"""Observability for the compiled path.

The counterpart of ``cortex_tpu/compile/tracing.py``.  Two complementary
tools:

- :func:`trace_run` — a *debug interpreter mode*: executes a
  :class:`~cortex_tpu_torch.compile.CompiledInference` sweep phase by phase,
  recording one :class:`TracedPhaseGroup` per batched rule call with wall
  time (the device synchronized after each call) and, optionally, value
  snapshots — the compiled analogue of the dynamic engine's
  Request→Round→Execution tracer,
- :func:`profile_run` — wraps a call in a ``torch.profiler`` trace of the
  host and the card, written as a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..utils import format_time_ns
from ..utils.tree import tree_leaves

__all__ = ["TracedPhaseGroup", "TracedSweep", "trace_run", "profile_run"]


class TracedPhaseGroup(NamedTuple):
    phase: int
    key: tuple
    n_steps: int
    wall_ns: int
    outputs: Optional[Any]  # stacked values if snapshots enabled


class TracedSweep(NamedTuple):
    groups: List[TracedPhaseGroup]
    total_ns: int
    marginals: Dict[int, Any]

    def __repr__(self) -> str:
        lines = [f"TracedSweep(total = {format_time_ns(self.total_ns)}, groups = ["]
        for g in self.groups:
            lines.append(
                f"  phase {g.phase}: {g.key[0]}/{g.key[1]} ×{g.n_steps} "
                f"in {format_time_ns(g.wall_ns)}"
            )
        lines.append("])")
        return "\n".join(lines)


def _block_until_ready(tree: Any) -> None:
    """Wait for the card when any tensor of ``tree`` lives there."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves(tree)):
        torch.cuda.synchronize()


def trace_run(
    compiled,
    inputs,
    state=None,
    *,
    snapshot_values: bool = False,
) -> TracedSweep:
    """Execute one sweep phase by phase with per-group timing (debug
    interpreter mode — do not use for performance measurement)."""
    from .executor import tree_stack, tree_unstack

    values = compiled._resolve_inputs(inputs)
    if state is None:
        state = compiled.initial_state()
    for sig, val in zip(compiled.schedule.initials, state):
        values[id(sig)] = val

    groups_out: List[TracedPhaseGroup] = []
    t_start = time.perf_counter_ns()
    for p, phase in enumerate(compiled.schedule.phases):
        for group in phase:
            t0 = time.perf_counter_ns()
            n_deps = group.key[2]
            dep_values = [
                tree_stack([values[id(st.deps[j])] for st in group.steps])
                for j in range(n_deps)
            ]
            out = compiled.processor.dispatch(compiled.engine, group, dep_values)
            _block_until_ready(out)
            for st, val in zip(group.steps, tree_unstack(out, len(group.steps))):
                values[id(st.signal)] = val
            groups_out.append(
                TracedPhaseGroup(
                    p,
                    group.key,
                    len(group.steps),
                    time.perf_counter_ns() - t0,
                    out if snapshot_values else None,
                )
            )
    total_ns = time.perf_counter_ns() - t_start
    marginals = {vid: values[id(sig)] for vid, sig in compiled.schedule.targets.items()}
    return TracedSweep(groups_out, total_ns, marginals)


@contextlib.contextmanager
def profile_run(log_dir: str):
    """Record a ``torch.profiler`` trace (the host, and the card when there
    is one) of everything inside the block; on exit it is written to
    ``log_dir/trace.json`` (Chrome trace format).  Yields the profiler, whose
    ``key_averages()`` tabulate the operations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
