"""Observations drawn from the two-level HGF's own generative model, with
the configuration's ``kappa``, ``omega``, ``theta`` and ``pi_u``, each
replica from 0 (Mathys et al. 2014, the model the filter inverts):

    x2_t = x2_{t-1} + N(0, theta)
    x1_t = x1_{t-1} + N(0, exp(kappa * x2_t + omega))
    u_t  = x1_t + N(0, 1 / pi_u)

float32, along the last axis; the walks are cumulative sums."""

import math

import torch


def make(config, traffic, shape, gen, device):
    def normal():
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    x2 = normal().mul_(math.sqrt(config["theta"])).cumsum_(-1)
    x1 = x2.mul_(config["kappa"]).add_(config["omega"]).mul_(0.5).exp_().mul_(normal())
    return x1.cumsum_(-1).add_(normal().mul_(1.0 / math.sqrt(config["pi_u"])))
