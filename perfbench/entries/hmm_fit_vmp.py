"""The system under test for the HMM's Dirichlet VMP fit:
``HMM(K, log_pi).fit_vmp(obs, M, n_iterations, trans_prior, emis_prior,
method=traffic["method"], pooled=config["pooled"])`` on one ``(R, T)`` batch
of integer symbols a call (``"fused"``: K3 a VMP iteration, then the
log-space smoothing pass)."""

from __future__ import annotations

import math

import torch

from perfbench import costs


class Entry:
    replica_dim = 0

    def __init__(self, config: dict, traffic: dict, device):
        from cortex_tpu_torch.models import HMM

        if config["pi"] != "uniform":
            raise ValueError(f"unknown initial distribution {config['pi']!r}")
        K = int(config["K"])
        self.model = HMM(K, torch.full((K,), -math.log(K), device=device))
        self.M = int(config["M"])
        self.n_iterations = int(config["n_iterations"])
        self.priors = float(config["trans_prior"]), float(config["emis_prior"])
        self.pooled = bool(config["pooled"])
        self.method = traffic["method"]
        R, T = int(traffic["replicas"]), int(config["T"])
        # n E-steps and the final smoothing pass, each a forward-backward pass
        # of R (3T - 2) message updates.
        self.updates_per_call = (self.n_iterations + 1) * R * (3 * T - 2)
        obs_bytes = torch.empty((), dtype=getattr(torch, traffic.get("dtype", "int64"))).element_size()
        self.cost = costs.hmm_fit(R, T, K, self.M, self.n_iterations, obs_bytes)

    def pack(self, ring):
        return ring

    def inputs(self, batch):
        return {"obs": batch}

    def call(self, batch):
        return self.model.fit_vmp(batch, self.M, n_iterations=self.n_iterations,
                                  trans_prior=self.priors[0], emis_prior=self.priors[1],
                                  method=self.method, pooled=self.pooled)

    def results(self, out):
        post = out.posterior
        return {"log_gamma": post.log_gamma, "log_xi_sum": post.log_xi_sum,
                "log_evidence": post.log_evidence, "trans_alpha": out.state.trans_alpha,
                "emis_alpha": out.state.emis_alpha, "elbo": out.elbo}


def build(config: dict, traffic: dict, device) -> Entry:
    return Entry(config, traffic, device)
