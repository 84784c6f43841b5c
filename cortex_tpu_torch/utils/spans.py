"""Spans and counters of the port's layers, on the profiler's clock.

A span is a ``with`` block named after the layer it times: the name starts
with the layer and a dot (``model.``, ``boundary.``, ``compiled.``,
``rules.``, ``ops.``, ``launch.``, ``setup.``, ``parallel.``,
``collective.``, ``stream.``).  ``stream.`` spans are the streaming layer's
(``parallel/streaming.py``): ``stream.filter``, the root of a stream
(``stream_filter``, ``StreamingSession.push`` and ``.flush``), around the
model's calls on each chunk; ``stream.stage``, a chunk's conversion, pin
check and copy enqueued on the side stream; ``stream.wait``, the compute
stream's wait for that copy.  ``parallel.`` spans are the roots of the parallel layer's
calls (``parallel.time_sharded``, ``parallel.mv_time_sharded``): the rank's
own work on its block; ``collective.`` spans are the exchanges between
ranks (``collective.all_gather``, ``.all_reduce``, ``.send_recv``, one an
exchange, a staged exchange's copies through the host included; an NCCL
exchange's span is its enqueue, its device time the profiler's to read).

- While no ``torch.profiler`` session is active, :func:`span` makes one
  check (``torch.autograd.profiler._is_profiler_enabled``, the flag that
  the profiler's sessions set for cheap checks: a read, where the C call
  ``torch.autograd._profiler_enabled()`` takes about as long as the rest of
  a span) and returns one shared object that does nothing.
- Inside any session, whatever its activities (``compile.tracing.
  profile_run``'s included), a span is emitted into the profiler's host
  timeline, on the clock of its device records, and timed into memory.

The first span opened on a thread with no span open is the root of a call.
A span's self time is its duration less the time its child spans cover, and
it counts to the span's layer.  When the root closes, the call's record is
kept (:func:`calls`): its id, start and end, each layer's self time (which
together make up the root's duration exactly) and each counter's increment
during the call.  At most :data:`CAP` records are kept; the rest are counted
in ``spans.dropped``.

Set-up spans (:func:`setup_span`: the imports, the kernels' build) run once
a process and are always timed (:func:`setup`); inside a session they are
emitted too, and count to the ``setup`` layer of a call they run in.

Counters are plain integers in one registry (:func:`counter_group`,
:func:`counts`), grouped by what they count: ``launch`` (each hand kernel's
launches, ``ops.kernels.LAUNCHES``), ``copy.h2d`` (``calls`` and ``bytes`` of
the port's uploads to the card, :func:`h2d`), ``compiled.graph`` (the
executor's ``captures``, ``replays`` and ``eager`` sweeps on the card),
``model.hmm.graph`` (the same of ``HMM.fit_vmp``'s fits on the card),
``collective`` (``calls`` and ``bytes`` sent by this rank, of every mesh's
exchanges), ``stream`` (``chunks`` and ``bytes`` staged by the streaming
layer, whose uploads count in ``copy.h2d`` too) and ``spans``
(``dropped``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "CAP",
    "CallRecord",
    "calls",
    "counter_group",
    "counts",
    "h2d",
    "reset",
    "setup",
    "setup_span",
    "span",
]

CAP = 65_536

# What a span emits into the profiler's host timeline.
_RECORD = torch._C._profiler._RecordFunctionFast


class CallRecord(NamedTuple):
    """One call, from its root span: self time in ns by layer, and the
    counters' increments (those that moved) during the call."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    layers: Dict[str, int]
    counts: Dict[str, int]


_COUNTERS: Dict[str, Dict[str, int]] = {}
_LAYERS: Dict[str, str] = {}  # span name -> layer
_RECORDS: List[CallRecord] = []
_SETUP_NS: Dict[str, int] = {}
_OPEN_SETUP: set = set()
_LOCAL = threading.local()
_LOCK = threading.Lock()  # the records and their ids, across threads
_NEXT_ID = [0]


def counter_group(group: str, keys: Sequence[str] = ()) -> Dict[str, int]:
    """The registry's dict of counters ``group`` (made on first use, with
    ``keys`` at 0): its readers and writers index it as a plain dict."""
    counters = _COUNTERS.setdefault(group, {})
    for key in keys:
        counters.setdefault(key, 0)
    return counters


_H2D = counter_group("copy.h2d", ("calls", "bytes"))
_SPANS = counter_group("spans", ("dropped",))


def counts() -> Dict[str, int]:
    """Every counter since the process started, as ``{"<group>.<key>": n}``."""
    return {f"{group}.{key}": n for group, keys in _COUNTERS.items() for key, n in keys.items()}


def h2d(t: torch.Tensor) -> torch.Tensor:
    """Count ``t`` in ``copy.h2d`` if it is not on the host, and return it:
    called on what an upload made."""
    if t.device.type != "cpu":
        _H2D["calls"] += 1
        _H2D["bytes"] += t.numel() * t.element_size()
    return t


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Off:
    """The span while no profiler session is active: entering and leaving
    it are C calls that do nothing (``str.__init__`` of an empty string takes
    any arguments and returns ``None``, which lets exceptions through)."""

    __slots__ = ()
    __enter__ = "".__init__
    __exit__ = "".__init__


_OFF = _Off()


class _Span:
    __slots__ = ("name", "layer", "child_ns", "t0", "rf", "stack", "layers", "counts0")

    def __init__(self, name: str):
        self.name = name
        layer = _LAYERS.get(name)
        if layer is None:
            layer = _LAYERS[name] = name.partition(".")[0]
        self.layer = layer
        self.child_ns = 0

    def __enter__(self):
        self.rf = rf = _RECORD(self.name)
        rf.__enter__()
        stack = self.stack = _stack()
        if not stack:
            self.layers = {}
            self.counts0 = [dict(group) for group in _COUNTERS.values()]
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = self.stack
        stack.pop()
        dur = t1 - self.t0
        layers = stack[0].layers if stack else self.layers
        layers[self.layer] = layers.get(self.layer, 0) + dur - self.child_ns
        if stack:
            stack[-1].child_ns += dur
        else:
            self._close(t1)
        self.rf.__exit__(*exc)
        return False

    def _close(self, t1: int) -> None:
        moved = {}
        for (group, now), before in zip(_COUNTERS.items(), self.counts0):
            if now != before:
                moved.update((f"{group}.{k}", n - before.get(k, 0)) for k, n in now.items()
                             if n != before.get(k, 0))
        with _LOCK:
            call_id = _NEXT_ID[0]
            _NEXT_ID[0] += 1
            if len(_RECORDS) < CAP:
                _RECORDS.append(CallRecord(call_id, self.name, self.t0, t1, self.layers, moved))
            else:
                _SPANS["dropped"] += 1


def span(name: str):
    """A span of the layer that ``name`` starts with; it does nothing unless
    a profiler session is active."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


class _SetupSpan:
    __slots__ = ("name", "outer", "inner", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.outer = self.name not in _OPEN_SETUP
        _OPEN_SETUP.add(self.name)
        self.inner = None
        if _profiler._is_profiler_enabled:
            # Within a call it is a span of the call; else only emitted.
            self.inner = _Span(self.name) if _stack() else _RECORD(self.name)
            self.inner.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.outer:
            _SETUP_NS[self.name] = _SETUP_NS.get(self.name, 0) + dur
            _OPEN_SETUP.discard(self.name)
        if self.inner is not None:
            self.inner.__exit__(*exc)
        return False


def setup_span(name: str) -> _SetupSpan:
    """A span of one-off set-up work, timed whether or not a profiler
    session is active; one nested in another of the same name is not
    counted again."""
    return _SetupSpan(name)


def calls() -> List[CallRecord]:
    """The records of the calls made inside profiler sessions since the
    process started (or :func:`reset`), oldest first."""
    with _LOCK:
        return list(_RECORDS)


def setup() -> Dict[str, float]:
    """Seconds spent in each set-up span since the process started."""
    return {name: ns / 1e9 for name, ns in _SETUP_NS.items()}


def reset() -> None:
    """Forget the call records and their ids (the set-up times and the
    counters stay)."""
    with _LOCK:
        _RECORDS.clear()
        _NEXT_ID[0] = 0
        _SPANS["dropped"] = 0
