"""Small shared utilities (reference Cortex.jl's ``src/utils.jl``)."""

from __future__ import annotations

__all__ = ["format_time_ns"]


def format_time_ns(t: float) -> str:
    """Format a nanosecond duration as a human-readable string
    (reference ``src/utils.jl:3-17``)."""
    t = float(t)
    if t < 1_000:
        return f"{t:.0f}ns"
    if t < 1_000_000:
        return f"{t / 1_000:.2f}μs"
    if t < 1_000_000_000:
        return f"{t / 1_000_000:.2f}ms"
    if t < 60 * 1_000_000_000:
        return f"{t / 1_000_000_000:.2f}s"
    if t < 3600 * 1_000_000_000:
        return f"{t / (60 * 1_000_000_000):.2f}min"
    return f"{t / (3600 * 1_000_000_000):.2f}hr"
