"""Dependency-graph visualization: render signals and schedules to DOT.

The counterpart of the reference's GraphViz extension
(``ext/GraphVizExt/GraphVizExt.jl:293-444``): node color
encodes computed (light yellow) / pending (light blue) state, edge style
encodes weak (dashed) / intermediate (gray) / fresh (blue), traversal is
bounded by ``max_depth`` / ``max_dependencies`` / ``max_listeners`` with
"N more" summary nodes; display knobs ``show_value`` / ``show_variant`` /
``show_listeners`` / ``variant_to_string_fn`` mirror ``GraphViz.load``'s
keyword surface (``GraphVizExt.jl:293-310``).  Output is a DOT string;
:func:`render_dot` / :func:`render_signal` run it through the ``dot``
engine when the graphviz binary is installed (clear error otherwise).

Also renders :class:`~cortex_tpu_torch.compile.StaticSchedule` phase plans — the
compiled-path observability surface.
"""

from .dot import render_dot, render_signal, schedule_to_dot, signal_to_dot

__all__ = ["signal_to_dot", "render_dot", "render_signal", "schedule_to_dot"]
