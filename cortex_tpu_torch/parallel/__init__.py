"""Streaming: host-to-card copies overlapped with the card's compute.

The replica mesh and the sharded variants of ``cortex_tpu.parallel`` are not
ported yet.
"""

from .streaming import StreamingSession, stream_filter

__all__ = ["stream_filter", "StreamingSession"]
