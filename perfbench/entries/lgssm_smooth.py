"""The system under test for the LGSSM's own entry point:
``LGSSM(A, Q, H, R).smooth(y, method=traffic["method"])`` on one ``(R, T)``
float32 batch a call (``"fused"``: K1)."""

from __future__ import annotations

from perfbench import costs


class Entry:
    replica_dim = 0

    def __init__(self, config: dict, traffic: dict, device):
        from cortex_tpu_torch.models import LGSSM

        self.model = LGSSM(config["A"], config["Q"], config["H"], config["R"])
        self.method = traffic["method"]
        R, T = int(traffic["replicas"]), int(config["T"])
        # A forward-backward pass over R replicas of T steps: R (3T - 2)
        # message updates (bench.py:1-10).
        self.updates_per_call = R * (3 * T - 2)
        self.cost = costs.lgssm_call(R, T)

    def pack(self, ring):
        return ring

    def inputs(self, batch):
        return {"y": batch}

    def call(self, batch):
        return self.model.smooth(batch, method=self.method)

    def results(self, out):
        return {"mean": out.mean, "variance": out.variance}


def build(config: dict, traffic: dict, device) -> Entry:
    return Entry(config, traffic, device)
