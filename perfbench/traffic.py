"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) gives the parameters; the
configuration gives the sizes of the model.  :func:`make_ring` makes, on the
device and from the seed alone, a ring of ``ring_batches`` distinct batches
of ``replicas`` rows of ``T`` steps, in a few large calls.  A run's calls take
the batches in turn, so a ring of more bytes than the card's L2 (50 MB) leaves
no call its inputs cached by the call before.

What the rows hold is the traffic's ``inputs`` kind, a file of its own found
by name: ``perfbench/inputs/<inputs>.py``, whose ``make(config, traffic,
shape, gen, device)`` returns the ring, drawn from ``gen`` alone.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any whole number; taken
    modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def make_ring(inputs, config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The ring, ``(ring_batches, replicas, T)``, the same for the same seed;
    ``inputs`` is the module of the traffic's inputs kind."""
    shape = (int(traffic["ring_batches"]), int(traffic["replicas"]), int(config["T"]))
    return inputs.make(config, traffic, shape, generator(seed, device), device)
