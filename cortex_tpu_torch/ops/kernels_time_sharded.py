"""One rank's local sweep of the time-sharded scalar LGSSM smoother as three CUDA
passes, beside their plain PyTorch versions.

:func:`cortex_tpu_torch.parallel.lgssm_smooth_time_sharded` smooths this
rank's block of a chain whose time axis is split over ranks; the ranks
exchange one filter 5-tuple ``(A, b, C, eta, J)`` and one smoother 3-tuple
``(E, g, L)`` per lane (Särkkä and García-Fernández 2020).  The block's own
work is :class:`LocalSweep`'s three passes, each reading the block once:

1. :meth:`LocalSweep.filter_total`: every step's filter element built from
   ``y`` on the fly and folded in time order; the block's 5-tuple per lane.
2. :meth:`LocalSweep.filter_fillin`: from the belief entering the block (the
   exclusive prefix of the gathered 5-tuples), the filtered means and
   variances, written into the outputs, and the block's smoother 3-tuple.
3. :meth:`LocalSweep.smoother_fillin`: from the smoothed moments after the
   block (the exclusive suffix of the gathered 3-tuples), the RTS fill-in,
   backwards, over the filtered moments in place.

Each lane's block is cut into :func:`plan`'s time segments, one thread each,
so that enough threads stream the block; a segment's pass starts from the
composition of the earlier (later, for pass 3) segments' totals, which the
previous pass left per segment.  There is no TPU kernel behind these: the
JAX package runs ``lax.associative_scan`` (``cortex_tpu/parallel/
time_sharded.py``).  The elements and combines are those of
``ops/chains.py`` (``_filter_combine``, ``_smoother_combine``), with each
combine's divisions by its denominator taken as one correctly rounded
reciprocal times the numerators.

On a float32 block on the card each pass launches its kernel of
``csrc/lgssm_time_sharded.cu`` (built at first use; a failed build or launch
raises), inside a ``launch.lgssm_time_sharded`` span, and counts it in
``kernels.LAUNCHES["lgssm_time_sharded"]``.  Any other block (every block on
the host, a float64 one on the card) runs the plain version: the same
segments and arithmetic as a loop over the steps of a segment, vectorised
over lanes and segments, in the block's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import spans
from .chains import _FilterElem, _SmootherElem, _smoother_combine
from . import kernels
from .kernels import LAUNCHES

__all__ = ["CHUNK", "LocalSweep", "SweepModel", "plan"]

# Steps of each segment the kernels stage in shared memory at a time (128
# bytes); segment lengths are multiples of it (csrc: kChunk).
CHUNK = 32
# Threads per block of the kernels (csrc: kThreads); a lane's segments lie in
# one warp, so a segment count divides 32.
THREADS = 128
MAX_SEGMENTS = 32
# A pass takes up to four waves of threads on the H100's 132 SMs (three blocks
# of 128 threads an SM: the staging takes 74 KB a block) and no segment shorter
# than MIN_SEGMENT steps.  More, shorter segments hide more of each step's
# latency: at 10,000 x 16,384 the passes took 2.50, 2.50 and 2.35 ms with 4, 8
# and 16 segments (an H100 80GB HBM3 at 700 W).
TARGET_THREADS = 4 * 132 * 3 * THREADS
MIN_SEGMENT = 256


def plan(lanes: int, T: int) -> Tuple[int, int]:
    """``(segments, segment_length)`` of a ``(lanes, T)`` block: the most
    segments (a power of two up to 32) that keep the threads within
    ``TARGET_THREADS`` and each segment at ``MIN_SEGMENT`` steps or more; a
    segment is ``ceil(T / segments)`` steps rounded up to a multiple of
    :data:`CHUNK` (the last segments may be shorter or empty)."""
    segments = 1
    while (segments < MAX_SEGMENTS and lanes * segments * 2 <= TARGET_THREADS
           and T >= 2 * segments * MIN_SEGMENT):
        segments *= 2
    steps = -(-T // segments)
    return segments, -(-steps // CHUNK) * CHUNK


class SweepModel(NamedTuple):
    """The numbers of every step's elements, from ``A, Q, H, R`` in float64
    (rounded to float32 on the way into the kernels), in the kernels' order
    (csrc: ``Model``)."""

    a: float  # A, C and J of every filter element but the chain's first
    c: float
    j: float
    k: float  # b = k * y, eta = eta * y
    eta: float
    h: float  # the first element: b = y / h, C = c1 without a prior
    r: float
    c1: float
    A: float  # the smoother elements
    AA: float
    Q: float

    @classmethod
    def of(cls, A: float, Q: float, H: float, R: float) -> "SweepModel":
        """The numbers of the model ``A, Q, H, R``'s elements."""
        S = H * Q * H + R
        K = Q * H / S
        return cls(a=(1.0 - K * H) * A, c=(1.0 - K * H) * Q, j=A * H * H * A / S, k=K,
                   eta=A * H / S, h=H, r=R, c1=R / (H * H), A=A, AA=A * A, Q=Q)


def _fcombine(e1, e2):
    """``chains._filter_combine`` with one reciprocal of the denominator."""
    inv = torch.reciprocal(1.0 + e1.C * e2.J)
    return _FilterElem(e2.A * e1.A * inv,
                       e2.A * (e1.b + e1.C * e2.eta) * inv + e2.b,
                       e2.A * e2.A * e1.C * inv + e2.C,
                       e1.A * (e2.eta - e2.J * e1.b) * inv + e1.eta,
                       e1.A * e1.A * e2.J * inv + e1.J)


def _belief(b, C, e):
    """The ``b`` and ``C`` of ``_fcombine((*, b, C, *, *), e)``: a belief
    carried through the element ``e``."""
    inv = torch.reciprocal(1.0 + C * e.J)
    return e.A * (b + C * e.eta) * inv + e.b, e.A * e.A * C * inv + e.C


def _smoother_element(m: SweepModel, fm, fP):
    Pp = m.AA * fP + m.Q
    E = fP * m.A / Pp
    return _SmootherElem(E, fm - E * m.A * fm, fP - E * m.A * fP)


def _where(mask, new, old):
    return type(old)(*(torch.where(mask, n, o) for n, o in zip(new, old)))


@functools.cache
def _signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the passes' C signatures declared: pointers, then lanes, T,
    segments, segment length, the first / last flags, the model's numbers (a
    host pointer), stream."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    plan = [i64, i32, i32, i32]
    lib.lgssm_ts_filter_total_f32.argtypes = [ptr] * 5 + plan + [i32, ptr, ptr]
    lib.lgssm_ts_filter_total_f32.restype = i32
    lib.lgssm_ts_filter_fillin_f32.argtypes = [ptr] * 10 + plan + [i32, i32, ptr, ptr]
    lib.lgssm_ts_filter_fillin_f32.restype = i32
    lib.lgssm_ts_smoother_fillin_f32.argtypes = [ptr] * 6 + plan + [i32, ptr, ptr]
    lib.lgssm_ts_smoother_fillin_f32.restype = i32
    return lib


def _library() -> ctypes.CDLL:
    """The kernels' one library (:func:`kernels._library`), the passes'
    signatures declared."""
    return _signatures(kernels._library())


class LocalSweep:
    """The three passes over one rank's block ``y``, ``(lanes, T)``,
    contiguous, on the host or the card: the kernels on a float32 block on
    the card, the plain versions on any other, in its dtype.

    ``first``: the block holds the chain's first step (the prior's element,
    ``prior = (m0, P0)``, each ``(lanes,)`` in ``y``'s dtype, or the first
    observation alone); ``last``: the block holds the chain's last step (its
    smoother element is terminal).  The block is cut as :func:`plan` says.
    The passes run in order, once each; the marginals land in ``mean`` and
    ``variance``.
    """

    def __init__(self, y: torch.Tensor, A: float, Q: float, H: float, R: float, *,
                 first: bool, last: bool,
                 prior: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if y.dim() != 2 or 0 in y.shape:
            raise ValueError(f"y must be a non-empty (lanes, T) block, got {tuple(y.shape)}")
        if y.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the local sweep runs on cpu or cuda, not {y.device}")
        if not y.is_contiguous():
            raise ValueError("y must be contiguous")
        lanes, T = y.shape
        if T >= 2**31:
            raise ValueError(f"a block of {T} steps is too long for the kernels")
        segments, length = plan(lanes, T)
        if prior is not None and not first:
            raise ValueError("only the block with the chain's first step takes the prior")
        self.y, self.first, self.last = y, first, last
        self.by_kernels = y.device.type == "cuda" and y.dtype == torch.float32
        self.model = SweepModel.of(float(A), float(Q), float(H), float(R))
        self._model_f32 = (ctypes.c_float * len(self.model))(*self.model)  # the kernels' copy
        self.prior = None if prior is None else self._lanes(*prior)
        self.segments, self.length = segments, length
        self.mean, self.variance = torch.empty_like(y), torch.empty_like(y)
        self.seg_filter = y.new_empty((lanes, segments, 5))
        self.seg_smoother = y.new_empty((lanes, segments, 3))

    # -- the passes -----------------------------------------------------------------------

    def filter_total(self) -> torch.Tensor:
        """Pass 1: the block's filter 5-tuple per lane, ``(5, lanes)``
        (rows A, b, C, eta, J)."""
        if not self.by_kernels:
            return self._filter_total_plain()
        total = self.y.new_empty((5, self.y.shape[0]))
        self._launch("filter_total", (self.y, total, self.seg_filter, *self._prior()),
                     self.first)
        return total

    def filter_fillin(self, prefix_b: torch.Tensor, prefix_C: torch.Tensor) -> torch.Tensor:
        """Pass 2: from the belief entering the block, ``(prefix_b,
        prefix_C)`` per lane (zeros where the block holds the chain's first
        step), the filtered moments into ``mean`` and ``variance``; returns
        the block's smoother 3-tuple per lane, ``(3, lanes)`` (rows E, g, L)."""
        prefix = self._lanes(prefix_b, prefix_C)
        if not self.by_kernels:
            return self._filter_fillin_plain(*prefix)
        total = self.y.new_empty((3, self.y.shape[0]))
        self._launch("filter_fillin", (self.y, self.mean, self.variance, total,
                                       self.seg_smoother, self.seg_filter, *prefix,
                                       *self._prior()), self.first, self.last)
        return total

    def smoother_fillin(self, E: torch.Tensor, g: torch.Tensor, L: torch.Tensor):
        """Pass 3: from the composition ``(E, g, L)`` per lane of the later
        blocks' smoother elements (``(1, 0, 0)`` where the block holds the
        chain's last step), the marginals, over the filtered moments in
        place; returns ``(mean, variance)``."""
        suffix = self._lanes(E, g, L)
        if not self.by_kernels:
            self._smoother_fillin_plain(*suffix)
        else:
            self._launch("smoother_fillin", (self.mean, self.variance, self.seg_smoother,
                                             *suffix), self.last)
        return self.mean, self.variance

    def _lanes(self, *fields: torch.Tensor):
        """``fields`` as the kernels read them: contiguous ``(lanes,)`` vectors
        in the block's dtype, on its device."""
        y = self.y
        for f in fields:
            if f.shape != y.shape[:1] or f.dtype != y.dtype or f.device != y.device:
                raise ValueError(f"expected a ({y.shape[0]},) {y.dtype} vector on {y.device}, "
                                 f"got {tuple(f.shape)} {f.dtype} on {f.device}")
        return tuple(f.contiguous() for f in fields)

    def _prior(self):
        return self.prior if self.prior is not None else (None, None)

    def _launch(self, name: str, tensors, *flags: bool) -> None:
        """Launch ``csrc/lgssm_time_sharded.cu``'s pass ``name`` on the
        tensors (``None``: a null pointer), this block's plan and flags."""
        with spans.span("launch.lgssm_time_sharded"):
            lib = _library()
            lanes, T = self.y.shape
            pointers = [None if t is None else t.data_ptr() for t in tensors]
            with torch.cuda.device(self.y.device):
                stream = torch.cuda.current_stream(self.y.device).cuda_stream
                err = getattr(lib, f"lgssm_ts_{name}_f32")(
                    *pointers, lanes, T, self.segments, self.length, *map(int, flags),
                    self._model_f32, stream)
            if err != 0:
                reason = lib.lgssm_cuda_error_string(err).decode()
                raise RuntimeError(f"lgssm_time_sharded {name} launch failed: {reason} ({err})")
            LAUNCHES["lgssm_time_sharded"] += 1

    # -- the plain versions -------------------------------------------------------------
    #
    # The block padded to (lanes, segments, length): step j of every segment
    # at once, the padding's steps masked out.

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        lanes, T = x.shape
        pad = self.segments * self.length - T
        return torch.nn.functional.pad(x, (0, pad)).view(lanes, self.segments, self.length)

    def _steps(self) -> torch.Tensor:
        """Each padded position's step index, ``(segments, length)``."""
        return torch.arange(self.segments * self.length, device=self.y.device).view(
            self.segments, self.length)

    def _first_element(self):
        """``(b, C)`` of the chain's first element, per lane."""
        m, y0 = self.model, self.y[:, 0]
        if self.prior is None:
            return y0 / m.h, torch.full_like(y0, m.c1)
        m0, P0 = self.prior
        S1 = m.h * P0 * m.h + m.r
        K1 = P0 * m.h / S1
        return m0 + K1 * (y0 - m.h * m0), P0 - K1 * m.h * P0

    def _element(self, yt):
        m = self.model
        return _FilterElem(torch.full_like(yt, m.a), m.k * yt, torch.full_like(yt, m.c),
                           m.eta * yt, torch.full_like(yt, m.j))

    def _filter_total_plain(self) -> torch.Tensor:
        yp, steps = self._padded(self.y), self._steps()
        T = self.y.shape[1]
        one, zero = torch.ones_like(yp[:, :, 0]), torch.zeros_like(yp[:, :, 0])
        acc = _FilterElem(one, zero, zero, zero, zero)
        for j in range(self.length):
            new = _fcombine(acc, self._element(yp[:, :, j]))
            if j == 0 and self.first:
                b1, C1 = self._first_element()
                new = _FilterElem(*(f.clone() for f in new))
                for field, value in zip(new, (0.0, b1, C1, 0.0, 0.0)):
                    field[:, 0] = value
            acc = _where(steps[:, j] < T, new, acc)
        self.seg_filter.copy_(torch.stack(acc, -1))
        total = _FilterElem(one[:, 0], zero[:, 0], zero[:, 0], zero[:, 0], zero[:, 0])
        for s in range(self.segments):
            total = _fcombine(total, _FilterElem(*(f[:, s] for f in acc)))
        return torch.stack(total)

    def _filter_fillin_plain(self, prefix_b, prefix_C) -> torch.Tensor:
        m, yp, steps = self.model, self._padded(self.y), self._steps()
        T = self.y.shape[1]
        seg = _FilterElem(*self.seg_filter.unbind(-1))
        b, C = [prefix_b], [prefix_C]  # the belief entering each segment
        for s in range(1, self.segments):
            nb, nC = _belief(b[-1], C[-1], _FilterElem(*(f[:, s - 1] for f in seg)))
            b.append(nb)
            C.append(nC)
        b, C = torch.stack(b, 1), torch.stack(C, 1)
        one, zero = torch.ones_like(b), torch.zeros_like(b)
        acc = _SmootherElem(one, zero, zero)
        fm, fP = torch.zeros_like(yp), torch.zeros_like(yp)
        for j in range(self.length):
            valid = steps[:, j] < T
            nb, nC = _belief(b, C, self._element(yp[:, :, j]))
            if j == 0 and self.first:
                b1, C1 = self._first_element()
                nb[:, 0], nC[:, 0] = b1, C1
            b, C = torch.where(valid, nb, b), torch.where(valid, nC, C)
            fm[:, :, j], fP[:, :, j] = b, C
            e = _smoother_element(m, b, C)
            if self.last:  # the chain's last element is terminal: (0, fm, fP)
                end = steps[:, j] == T - 1
                e = _SmootherElem(torch.where(end, 0.0, e.E), torch.where(end, b, e.g),
                              torch.where(end, C, e.L))
            acc = _where(valid, _smoother_combine(e, acc), acc)
        lanes = self.y.shape[0]
        self.mean.copy_(fm.view(lanes, -1)[:, :T])
        self.variance.copy_(fP.view(lanes, -1)[:, :T])
        self.seg_smoother.copy_(torch.stack(acc, -1))
        total = _SmootherElem(one[:, 0], zero[:, 0], zero[:, 0])
        for s in range(self.segments):
            total = _smoother_combine(_SmootherElem(*(f[:, s] for f in acc)), total)
        return torch.stack(total)

    def _smoother_fillin_plain(self, E, g, L) -> None:
        m, steps = self.model, self._steps()
        T = self.y.shape[1]
        seg = _SmootherElem(*self.seg_smoother.unbind(-1))
        entering = [_SmootherElem(E, g, L)]  # after each segment, from the last back
        for s in range(self.segments - 1, 0, -1):
            later = _SmootherElem(*(f[:, s] for f in seg))
            entering.append(_smoother_combine(entering[-1], later))
        acc = _SmootherElem(*(torch.stack(f[::-1], 1) for f in zip(*entering)))
        fm, fP = self._padded(self.mean), self._padded(self.variance)
        mean, var = torch.zeros_like(fm), torch.zeros_like(fP)
        for j in range(self.length - 1, -1, -1):
            valid = steps[:, j] < T
            e = _smoother_element(m, fm[:, :, j], fP[:, :, j])
            if self.last:
                end = steps[:, j] == T - 1
                e = _SmootherElem(torch.where(end, 0.0, e.E), torch.where(end, fm[:, :, j], e.g),
                              torch.where(end, fP[:, :, j], e.L))
            acc = _where(valid, _smoother_combine(acc, e), acc)
            mean[:, :, j], var[:, :, j] = acc.g, acc.L
        lanes = self.y.shape[0]
        self.mean.copy_(mean.view(lanes, -1)[:, :T])
        self.variance.copy_(var.view(lanes, -1)[:, :T])
