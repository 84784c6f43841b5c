"""Pipeline-parallel LGSSM smoothing: boundary messages passed between ranks.

The counterpart of ``cortex_tpu/parallel/pipelined.py``.
:mod:`cortex_tpu_torch.parallel.time_sharded` removes the time recursion
(associative scan + one ``all_gather``); this module keeps the *sequential*
forward/backward recursion and distributes it as pipeline parallelism:

- the time axis is split into contiguous blocks, one per rank along the
  ``time`` mesh axis (pipeline *stages*);
- the replica batch is split into *microbatches*;
- each stage runs the in-block recursion for one microbatch, then hands the
  2-scalar-per-replica boundary message (the filtered belief in information
  form) to the next stage — one ``batch_isend_irecv`` a tick, the port's
  ``lax.ppermute``;
- while stage 1 processes microbatch k, stage 0 processes microbatch k+1.
  The bubble fraction is ``(n_stages - 1) / (n_stages + n_micro - 1)``.

The backward sweep runs the same pipeline mirrored.  Exact marginals,
identical to :func:`cortex_tpu_torch.ops.lgssm_smooth_scan`'s.  Explicit
SPMD: every rank of the axis calls the function on its own time block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.chains import ChainMarginals, _obs_message
from .mesh import Mesh, send_recv

__all__ = ["lgssm_smooth_pipelined"]


def _fwd_block(carry, xi_o, w_o, A, Q):
    """The forward message recursion over one local time block.

    ``carry`` is the filtered belief of the last state of the previous block,
    in information form ``(xi, w)``; the zero-information carry ``(0, 0)`` is
    the correct boundary for the first global block (no forward message into
    x_1).  ``xi_o``/``w_o`` are time-major ``(T_blk, mb)``.  Returns
    ``(carry_out, (xi_msgs, w_msgs))`` with the messages shaped like ``xi_o``.
    """
    xi_f, w_f = carry
    xi_msgs, w_msgs = [], []
    for t in range(xi_o.shape[0]):
        denom = A * A + Q * w_f
        xi_msgs.append(A * xi_f / denom)
        w_msgs.append(w_f / denom)
        xi_f, w_f = xi_msgs[t] + xi_o[t], w_msgs[t] + w_o[t]
    return (xi_f, w_f), (torch.stack(xi_msgs), torch.stack(w_msgs))


def _bwd_block(carry, xi_o, w_o, A, Q):
    """The backward message recursion over one local block, from its end.

    ``carry`` is the product of the observation and backward messages at the
    first state of the *next* block; ``(0, 0)`` is correct for the last
    global block (no backward message into x_T).  Messages are returned in
    forward time order.
    """
    xi_b, w_b = carry
    xi_msgs, w_msgs = [], []
    for t in range(xi_o.shape[0] - 1, -1, -1):
        denom = 1.0 + Q * w_b
        xi_msgs.append(A * xi_b / denom)
        w_msgs.append(A * A * w_b / denom)
        xi_b, w_b = xi_msgs[-1] + xi_o[t], w_msgs[-1] + w_o[t]
    return (xi_b, w_b), (torch.stack(xi_msgs[::-1]), torch.stack(w_msgs[::-1]))


def _pipeline(xi_o, w_o, A, Q, *, mesh: Mesh, axis: str, n_micro: int, forward: bool):
    """Run one pipelined sweep over the local block; returns the messages.

    ``xi_o``/``w_o``: ``(batch, T_blk)`` local observation messages.  The
    sweep carry (one ``(xi, w)`` pair per replica of the active microbatch)
    moves stage → stage+1 (forward) or stage → stage-1 (backward) after every
    tick, stacked as one ``(2, mb)`` tensor.  A stage outside the permutation
    receives nothing and keeps zeros — exactly the zero-information boundary
    carry.  A stage with no microbatch in a tick skips its block but not the
    exchange, which every stage of the permutation makes every tick.
    """
    n_stage = mesh.shape[axis]
    stage = mesh.axis_index(axis)
    mb = xi_o.shape[0] // n_micro
    block = _fwd_block if forward else _bwd_block
    step = 1 if forward else -1
    my_pos = stage if forward else n_stage - 1 - stage
    send_to = stage + step if 0 <= stage + step < n_stage else None
    recv_from = stage - step if 0 <= stage - step < n_stage else None

    out_xi, out_w = torch.zeros_like(xi_o), torch.zeros_like(w_o)
    zeros = torch.zeros((2, mb), dtype=xi_o.dtype, device=xi_o.device)
    carry = zeros
    for s in range(n_stage + n_micro - 1):
        m = s - my_pos  # the microbatch this stage works on in this tick
        carry_out = zeros
        if 0 <= m < n_micro:
            rows = slice(m * mb, (m + 1) * mb)
            # The block works time-major: pass (T_blk, mb), get msgs back the same.
            (xi_c, w_c), (xi_msgs, w_msgs) = block(
                (carry[0], carry[1]), xi_o[rows].T, w_o[rows].T, A, Q)
            out_xi[rows], out_w[rows] = xi_msgs.T, w_msgs.T
            carry_out = torch.stack([xi_c, w_c])
        # Halo exchange: the boundary belief to the next pipeline stage.
        received = send_recv(carry_out, mesh, axis, send_to, recv_from)
        carry = zeros if received is None else received
    return out_xi, out_w


def lgssm_smooth_pipelined(
    y: torch.Tensor,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    n_micro: Optional[int] = None,
    prior: Optional[Tuple[float, float]] = None,
) -> ChainMarginals:
    """Pipeline-parallel BP smoothing of this rank's block ``y`` shaped
    ``(batch, T_blk)``: the time axis is split over ``time_axis`` (pipeline
    stages), the replica ``batch`` into ``n_micro`` microbatches (default:
    the number of stages).  Exact Kalman/RTS marginals of the block; NaN
    entries are missing observations.
    """
    if y.dim() != 2:
        raise ValueError(f"pipelined smoothing expects (batch, T), got {tuple(y.shape)}")
    B = y.shape[0]
    n_stage = mesh.shape[time_axis]
    n_micro = n_stage if n_micro is None else n_micro
    if B % n_micro:
        raise ValueError(f"batch={B} must divide into {n_micro} microbatches")

    xi_o, w_o = _obs_message(y, H, R)  # (B, T_blk)
    if prior is not None and mesh.axis_index(time_axis) == 0:
        pm, pv = prior
        xi_o[:, 0] += pm / pv
        w_o[:, 0] += 1.0 / pv

    def run(forward):
        return _pipeline(xi_o, w_o, A, Q, mesh=mesh, axis=time_axis, n_micro=n_micro,
                         forward=forward)

    xi_f, w_f = run(forward=True)
    xi_b, w_b = run(forward=False)
    xi_m = xi_o + xi_f + xi_b
    w_m = w_o + w_f + w_b
    return ChainMarginals(xi_m / w_m, 1.0 / w_m)
