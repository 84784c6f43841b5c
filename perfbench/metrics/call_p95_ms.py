"""``call_p95_ms``: the 95th percentile, over every call of the window, of
the time from just before the call until its results are complete on the
card.  Each call is timed by a pair of CUDA events on the card's clock: the
first is recorded on the idle stream just before the call, the second after
it returns, and the loop waits on the second before the next call; the
times are read after the window (``harness.Clock``)."""


def percentile(values, q: float) -> float:
    """The ``q``-quantile of ``values``, interpolated between order statistics."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(run):
    calls = run.window.call_s
    return percentile(calls, 0.95) * 1e3 if calls else None
