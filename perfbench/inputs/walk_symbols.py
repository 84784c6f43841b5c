"""Symbols ``|random walk| mod M`` as integers of the traffic's ``dtype``
(default int64), ``M`` the configuration's symbols, the walk
``cumsum(N(0, 1))`` along time (``bench.py:598-603``)."""

import torch


def make(config, traffic, shape, gen, device):
    walk = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).cumsum_(-1)
    dtype = getattr(torch, traffic.get("dtype", "int64"))
    return walk.abs_().to(dtype).remainder_(int(config["M"]))
