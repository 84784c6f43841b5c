"""Reduce a ``torch.profiler`` trace of a traced part of the window to what
the readers and the ``breakdown`` need.

A run traces two parts of its loop.  The first records the device alone
(``ProfilerActivity.CUDA``: its kernels, copies and fills, and the CUDA
runtime calls that launched them), which slows the host little; its window
is the span of every event it holds, and the readers read it.  The second,
shorter, records the host's operations too, which slows the host: it only
names the idle gaps.  There the benchmark's own host spans (``bench.window``
around the loop, ``bench.call`` around each entry call up to its return,
``bench.wait`` around the wait for its results) share the trace's clock with
the device records; between them the host is in the benchmark's own loop
(``bench.loop``).

Busy time is the union of the device records inside the window; idle time
is the rest of it, each idle gap named by what the host was doing at its
middle: the benchmark span and the innermost operation open there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"
LOOP = "bench.loop"  # the benchmark's own loop, between its spans
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds)
    copies: List[Tuple[str, float]] = field(default_factory=list)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, match) -> List[float]:
        """Durations of the kernels whose name ``match(name)`` accepts."""
        return [s for name, s in self.kernels if match(name)]

    def device_ops(self) -> List[list]:
        """The device operations that took the most time, ``[[name, s], ...]``."""
        by_name: Dict[str, float] = {}
        for name, s in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0.0) + s
        return [[n[:160], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        return [[n[:160], s] for n, s in
                sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]]


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``[start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def host_labels(host: List[Tuple[int, int, str]], points: List[int]) -> List[str]:
    """For each of the sorted ``points``, ``"<bench span> > <innermost op>"``
    of the nested host events ``(start, end, name)`` open there."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    labels, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            stack.append(host[i])
            i += 1
        stack = [e for e in stack if e[1] > p]
        bench = [e[2] for e in stack if e[2].startswith("bench.") and e[2] != WINDOW]
        inner = [e[2] for e in stack if not e[2].startswith("bench.")]
        labels.append(" > ".join(([bench[-1]] if bench else [LOOP]) + inner[-1:]))
    return labels


def reduce(device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
           calls: int, labelled: bool = True) -> Trace:
    """A :class:`Trace` from the device records and the host events of one
    thread, ``(start_ns, end_ns, name)``.  ``labelled``: ``host`` holds the
    ``bench.window`` span, which is the window; else the window spans every
    event."""
    if labelled:
        windows = [e for e in host if e[2] == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} {WINDOW} spans, not 1")
        w0, w1 = windows[0][0], windows[0][1]
    else:
        events = device + host
        if not events:
            raise ValueError("the trace holds no event")
        w0, w1 = min(e[0] for e in events), max(e[1] for e in events)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = merge([(s, e) for s, e, _ in inside])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    idle: Dict[str, float] = {}
    for (s, e), label in zip(gaps, host_labels(host, [(s + e) // 2 for s, e in gaps])):
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    kernels = [(n, (e - s) / 1e9) for s, e, n in inside if not n.startswith(COPY_PREFIXES)]
    copies = [(n, (e - s) / 1e9) for s, e, n in inside if n.startswith(COPY_PREFIXES)]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(e - s for s, e in busy) / 1e9,
                 calls=calls, kernels=kernels, copies=copies, idle_by_host=idle)


def from_profiler(prof, calls: int, labelled: bool = True) -> Trace:
    """:func:`reduce` of a finished ``torch.profiler.profile``: its device
    records and its host events (``labelled``: those of the thread that ran
    ``bench.window``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or ev.name().startswith("bench."):
                continue  # the device side of a host span, not an operation
            if dur > 0:
                device.append((start, start + dur, ev.name()))
        else:
            host.append((start, start + max(dur, 0), ev.name(), ev.start_thread_id()))
    threads = {tid for s, e, n, tid in host if n == WINDOW or not labelled}
    host = [(s, e, n) for s, e, n, tid in host if tid in threads]
    return reduce(device, host, calls, labelled)
