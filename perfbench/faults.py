"""Faults planted under a cell's timed path, which its check must catch.

Each takes a built entry and returns one whose calls are broken in one way;
``harness.run_cell(..., wrap=fault)`` drives a whole run with it.  Used by
the tests, on the CPU, and by ``control.py``, on the card:

- ``answer``: one answer altered where it is produced (the largest entry of
  the call's first result, plus one);
- ``half``: half of the batch left out (its second half replaced by the
  first half's inputs);
- ``unchanged``: every iteration after the first returns its state unchanged
  (an entry with iterations only).
"""

from __future__ import annotations

import torch


class _Broken:
    """``entry`` with another ``call``."""

    def __init__(self, entry, call):
        self._entry = entry
        self.call = call

    def __getattr__(self, name):
        return getattr(self._entry, name)


def answer(entry):
    def call(batch):
        out = entry.call(batch)
        first = next(iter(entry.results(out).values()))
        index = torch.unravel_index(first.argmax(), first.shape)
        first[index] += 1.0
        return out
    return _Broken(entry, call)


def half(entry):
    def call(batch):
        dim = entry.replica_dim
        n = batch.shape[dim]
        broken = batch.clone()
        broken.narrow(dim, n // 2, n - n // 2).copy_(batch.narrow(dim, 0, n - n // 2))
        return entry.call(broken)
    return _Broken(entry, call)


def unchanged(entry):
    if not hasattr(entry, "n_iterations"):
        raise ValueError("the entry has no iterations to leave unchanged")
    entry.n_iterations = 1
    return entry


FAULTS = {"answer": answer, "half": half, "unchanged": unchanged}
