"""DOT rendering of signal graphs and compiled schedules."""

from __future__ import annotations

import shutil
import subprocess
from typing import Callable, Dict, List, Optional

from ..core.signal import Signal, UNDEF_VARIANT

__all__ = ["signal_to_dot", "render_dot", "render_signal", "schedule_to_dot"]

# State colors mirror the reference (ext/GraphVizExt/GraphVizExt.jl:6-14).
_COLOR_COMPUTED = "lightyellow"
_COLOR_PENDING = "lightblue"
_COLOR_UNDEF = "white"


def _node_color(s: Signal) -> str:
    if s.is_pending():
        return _COLOR_PENDING
    if s.is_computed():
        return _COLOR_COMPUTED
    return _COLOR_UNDEF


def _default_variant_str(variant) -> str:
    parts = [type(variant).__name__]
    fields = getattr(variant, "__dataclass_fields__", None)
    if fields:
        vals = ", ".join(f"{name}={getattr(variant, name)!r}" for name in fields)
        parts.append(f"({vals})")
    return "".join(parts)


def _node_label(
    s: Signal,
    show_value: bool = True,
    show_variant: bool = True,
    variant_to_string_fn: Optional[Callable] = None,
) -> str:
    parts = []
    if show_variant and s.variant is not UNDEF_VARIANT:
        to_str = variant_to_string_fn or _default_variant_str
        parts.append(str(to_str(s.variant)))
    if show_value:
        if s.is_computed():
            v = repr(s.get_value())
            if len(v) > 30:
                v = v[:27] + "..."
            parts.append(f"= {v}")
        else:
            parts.append("#undef")
    return "\\n".join(parts) if parts else "Signal"


def signal_to_dot(
    signal: Signal,
    *,
    max_depth: int = 3,
    max_dependencies: int = 8,
    max_listeners: int = 4,
    include_listeners: bool = True,
    show_value: bool = True,
    show_variant: bool = True,
    show_listeners: Optional[bool] = None,
    variant_to_string_fn: Optional[Callable] = None,
) -> str:
    """Render ``signal``'s dependency/listener neighborhood as a DOT digraph.

    Edge styles follow the reference (``ext/GraphVizExt/GraphVizExt.jl:
    17-39``): weak → dashed, intermediate → gray, fresh → blue.  Display
    knobs mirror ``GraphViz.load``'s keyword surface
    (``ext/GraphVizExt/GraphVizExt.jl:293-310``): ``show_value`` /
    ``show_variant`` toggle label content, ``show_listeners`` toggles the
    listener edges (alias of ``include_listeners``), and
    ``variant_to_string_fn`` customizes variant formatting.
    """
    if show_listeners is not None:
        include_listeners = show_listeners
    ids: Dict[int, str] = {}
    lines: List[str] = [
        "digraph Signals {",
        "  rankdir=BT;",
        '  node [shape=box, style="filled,rounded", fontsize=10];',
    ]
    counter = [0]

    def node_id(s: Signal) -> str:
        if id(s) not in ids:
            ids[id(s)] = f"s{counter[0]}"
            counter[0] += 1
            label = _node_label(s, show_value, show_variant, variant_to_string_fn)
            lines.append(
                f'  {ids[id(s)]} [label="{label}", '
                f'fillcolor={_node_color(s)}];'
            )
        return ids[id(s)]

    visited: set = set()

    def walk(s: Signal, depth: int) -> None:
        if id(s) in visited:
            return
        visited.add(id(s))
        sid = node_id(s)
        if depth >= max_depth:
            return
        deps = s.get_dependencies()
        for i, dep in enumerate(deps[:max_dependencies]):
            did = node_id(dep)
            styles = []
            if s.dep_is_weak(i):
                styles.append("dashed")
            color = "black"
            if s.dep_is_intermediate(i):
                color = "gray"
            if s.dep_is_fresh(i):
                color = "blue"
            style_attr = f', style="{",".join(styles)}"' if styles else ""
            lines.append(f"  {sid} -> {did} [color={color}{style_attr}];")
            walk(dep, depth + 1)
        if len(deps) > max_dependencies:
            more = f"{sid}_more_deps"
            lines.append(
                f'  {more} [label="{len(deps) - max_dependencies} more", '
                "shape=plaintext];"
            )
            lines.append(f"  {sid} -> {more} [style=dotted];")
        if include_listeners and depth == 0:
            listeners = s.get_listeners()
            for listener in listeners[:max_listeners]:
                lid = node_id(listener)
                lines.append(f"  {lid} -> {sid} [color=gray, style=dotted];")
            if len(listeners) > max_listeners:
                more = f"{sid}_more_listeners"
                lines.append(
                    f'  {more} [label="{len(listeners) - max_listeners} more '
                    'listeners", shape=plaintext];'
                )
                lines.append(f"  {more} -> {sid} [style=dotted];")

    walk(signal, 0)
    lines.append("}")
    return "\n".join(lines)


def render_dot(dot: str, format: str = "svg") -> bytes:
    """Render a DOT string through the ``dot`` engine — the analogue of the
    reference's ``GraphViz.Graph`` + ``layout!(engine="dot")`` step
    (``ext/GraphVizExt/GraphVizExt.jl:339-341``).

    Requires the graphviz ``dot`` binary on PATH; raises ``RuntimeError``
    with a clear message when it is absent (the pure-DOT strings remain
    available without it).
    """
    exe = shutil.which("dot")
    if exe is None:
        raise RuntimeError(
            "graphviz 'dot' binary not found on PATH; install graphviz or "
            "use the DOT string directly (signal_to_dot/schedule_to_dot)."
        )
    proc = subprocess.run(
        [exe, f"-T{format}"],
        input=dot.encode(),
        capture_output=True,
        check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"dot failed: {proc.stderr.decode()[:500]}")
    return proc.stdout


def render_signal(signal: Signal, format: str = "svg", **kwargs) -> bytes:
    """:func:`signal_to_dot` + :func:`render_dot` in one call."""
    return render_dot(signal_to_dot(signal, **kwargs), format=format)


def schedule_to_dot(schedule) -> str:
    """Render a :class:`~cortex_tpu_torch.compile.StaticSchedule` as a phase DAG:
    one node per (phase, rule-key) group, sized by group width."""
    lines = [
        "digraph Schedule {",
        "  rankdir=TB;",
        '  node [shape=box, style="filled", fillcolor=lightyellow, fontsize=10];',
    ]
    lines.append(
        f'  sources [label="{len(schedule.sources)} sources", fillcolor=white];'
    )
    if schedule.initials:
        lines.append(
            f'  initials [label="{len(schedule.initials)} initials '
            '(iteration state)", fillcolor=lightgray];'
        )
    prev = ["sources"] + (["initials"] if schedule.initials else [])
    for p, phase in enumerate(schedule.phases):
        names = []
        for gi, group in enumerate(phase):
            name = f"p{p}g{gi}"
            kind, form, arity = group.key
            form_str = f" [{form}]" if form is not None else ""
            lines.append(
                f'  {name} [label="phase {p}: {kind}{form_str}\\n'
                f'×{len(group.steps)} (arity {arity})"];'
            )
            names.append(name)
            for pr in prev:
                lines.append(f"  {pr} -> {name};")
        prev = names
    lines.append("}")
    return "\n".join(lines)
