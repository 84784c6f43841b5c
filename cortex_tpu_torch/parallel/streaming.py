"""Streaming ingestion: host-to-card copies overlapped with the card's compute.

The counterpart of ``cortex_tpu/parallel/streaming.py``.  The filtering
posterior stays on the card as carried state, and while the card computes on
chunk *i*, chunk *i+1* is already being copied: it goes from pinned host
memory with ``non_blocking=True`` on a side CUDA stream, an event is recorded
there, and the compute stream waits on that event before it uses the chunk
(double buffering).  On ``device="cpu"`` the same functions simply run in
order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

__all__ = ["stream_filter", "StreamingSession"]

# A chunk on its way to the device: the tensor, and the event that marks the
# end of its copy (None when there is nothing to wait for).
_Staged = Tuple[torch.Tensor, Optional[torch.cuda.Event]]


class _Stager:
    """Copies chunks to ``device`` on a side stream of its own."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def put(self, chunk) -> _Staged:
        """Start the copy of ``chunk`` (a tensor or an array) to the device."""
        host = torch.as_tensor(chunk)
        if self.stream is None or host.device == self.device:
            return host.to(self.device), None
        if host.device.type == "cpu" and not host.is_pinned():
            host = host.pin_memory()
        with torch.cuda.stream(self.stream):
            staged = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return staged, done

    def take(self, staged: _Staged) -> torch.Tensor:
        """The chunk, once the compute stream has been told to wait for its copy."""
        tensor, done = staged
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            # Allocated on the side stream, used on the compute stream: keep the
            # caching allocator from handing its memory out while that runs.
            tensor.record_stream(compute)
        return tensor


def stream_filter(
    chunk_step: Callable[[Any, torch.Tensor], Tuple[Any, Any]],
    chunks: Iterable[Any],
    init_state: Any,
    device="cuda",
) -> Tuple[Any, List[Any]]:
    """Run ``state, out = chunk_step(state, chunk)`` over a chunk stream with
    the next chunk's copy to ``device`` always in flight.

    Outputs are collected per chunk, on the device; read them at the end, so
    as not to synchronize the pipeline.  A ``None`` chunk ends the stream.
    """
    stager = _Stager(device)
    it = iter(chunks)
    outputs: List[Any] = []
    state = init_state

    first = next(it, None)
    if first is None:
        return state, outputs
    current = stager.put(first)
    while True:
        # Start the next copy before computing on the current chunk, so the
        # copy overlaps the compute.
        nxt = next(it, None)
        if nxt is not None:
            nxt = stager.put(nxt)
        state, out = chunk_step(state, stager.take(current))
        outputs.append(out)
        if nxt is None:
            break
        current = nxt
    return state, outputs


class StreamingSession:
    """Stateful streaming inference: push chunks, read the running posterior.

    The online analogue of the reference's repeated ``set_value!`` /
    ``update_marginals!`` loop, with the posterior carried on the device.

    Example::

        session = StreamingSession(lambda st, c: hgf.filter(c, state=st),
                                   hgf.init_state((R,)))
        for chunk in source:
            session.push(chunk)
        posterior = session.flush()
    """

    def __init__(
        self,
        chunk_step: Callable[[Any, torch.Tensor], Tuple[Any, Any]],
        init_state: Any,
        device="cuda",
    ) -> None:
        self._step = chunk_step
        self._stager = _Stager(device)
        self.state = init_state
        self._pending: Optional[_Staged] = None
        self.outputs: list = []

    def push(self, chunk) -> None:
        """Start the chunk's copy, then compute on the chunk staged before it;
        both run asynchronously."""
        staged = self._stager.put(chunk)
        if self._pending is not None:
            self.state, out = self._step(self.state, self._stager.take(self._pending))
            self.outputs.append(out)
        self._pending = staged

    def flush(self) -> Any:
        """Compute on any staged chunk and wait until the posterior is ready."""
        if self._pending is not None:
            self.state, out = self._step(self.state, self._stager.take(self._pending))
            self.outputs.append(out)
            self._pending = None
        if self._stager.stream is not None:
            torch.cuda.current_stream(self._stager.device).synchronize()
        return self.state
