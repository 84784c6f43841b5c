"""float32 Gaussian random walks, ``cumsum(N(0, 1))`` along time
(``bench.py:198-204``)."""

import torch


def make(config, traffic, shape, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).cumsum_(-1)
