"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): the denominators of every roofline share and of ``step_mfu``.

Frozen here, so that no change to the program moves the yardstick.
"""

from __future__ import annotations

# Float32 outside the tensor cores; every kernel measured here computes so.
FLOAT32_FLOPS = 67e12
# HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` operations moving
    ``nbytes`` bytes: the larger of the two bounds."""
    return max(flops / FLOAT32_FLOPS, nbytes / HBM_BYTES_PER_S)
