"""The operations and bytes of the HGF kernel K4 and of a streamed HGF call,
counted from the shapes alone: each input byte read once, each output byte
written once.

Copied from the program and frozen, so that a later change to the program
cannot move the yardstick: :func:`k4` is ``kernels_hgf._cost`` of
``cortex_tpu_torch/ops`` with float32 tracks, as it stood when the
``hgf.stream-64k`` cell was written.  Every function returns ``(operations,
bytes)``.
"""

from __future__ import annotations

from typing import Tuple

F32 = 4
# Operations of one replica-step: about 35 float32 adds, multiplies and
# compares, plus one exp and five reciprocals or divisions on the special
# function unit (16 a cycle per SM against 128 float32 lanes), each counted
# as 8.
OPS_PER_STEP = 35 + 8 * 6


def k4(R: int, T: int, n_tracks: int, state: bool) -> Tuple[float, float]:
    """K4 over ``(R, T)`` float32 observations: u read; the initial state
    (four float32 a replica) read when ``state``; the final state written,
    and ``n_tracks`` float32 tracks of ``(R, T)``."""
    nbytes = F32 * R * T + (4 * F32 * R if state else 0) + 4 * F32 * R + F32 * n_tracks * R * T
    return float(OPS_PER_STEP * R * T), float(nbytes)


def hgf_stream_call(R: int, T: int, chunk: int, n_tracks: int = 5) -> Tuple[float, float]:
    """One stream of ``R`` replicas over ``T`` steps in chunks of ``chunk``:
    one K4 a chunk, each from the state the one before left (the first from
    the initial state), with ``n_tracks`` float32 tracks."""
    ops = nbytes = 0.0
    for t0 in range(0, T, chunk):
        o, b = k4(R, min(chunk, T - t0), n_tracks, True)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
