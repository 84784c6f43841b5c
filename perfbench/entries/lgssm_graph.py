"""The system under test for the compiled path: the LGSSM chain as a factor
graph (``make_chain_graph(T)``), compiled by ``CompiledInference(engine, x,
LGSSMChainBatched(), lower=traffic["lower"])`` and run on one batch a call,
``run({}, source_pack=batch, packed=True)``, its marginals stacked and their
means and variances read, as a user reads them.

The graph's rules are the unit-parameter chain, so the configuration must
have ``A = Q = H = R = 1``.  The ring is packed once, at set-up, into the
``(T, R)`` layout, rows in the compiled program's source order, that
``source_pack`` takes, so the timed call is the sweep alone.
"""

from __future__ import annotations

import torch

from perfbench import costs


class Entry:
    replica_dim = 1

    def __init__(self, config: dict, traffic: dict, device):
        from cortex_tpu_torch.compile import CompiledInference, smart_stack
        from cortex_tpu_torch.models import LGSSMChainBatched, make_chain_graph

        if any(float(config[k]) != 1.0 for k in ("A", "Q", "H", "R")):
            raise ValueError("the chain graph's rules are the unit-parameter chain: A = Q = H = R = 1")
        T = int(config["T"])
        engine, self.x, y, _ = make_chain_graph(T)
        self.compiled = CompiledInference(engine, self.x, LGSSMChainBatched(),
                                          lower=bool(traffic["lower"]))
        self.stack = smart_stack
        step = {v: i for i, v in enumerate(y)}
        self.order = torch.tensor([step[key[1]] for key in self.compiled.source_keys()],
                                  device=device)
        R = int(traffic["replicas"])
        self.updates_per_call = R * (3 * T - 2)
        self.cost = costs.lgssm_call(R, T)

    def pack(self, ring):
        return ring.transpose(1, 2)[:, self.order].contiguous()

    def inputs(self, batch):
        y = torch.empty_like(batch)
        y[self.order] = batch
        return {"y": y.t()}

    def call(self, batch):
        marginals, _ = self.compiled.run({}, source_pack=batch, packed=True)
        family = self.stack([marginals[v] for v in self.x])  # (T, R), information form
        return family.mean, family.variance

    def results(self, out):
        return {"mean": out[0].t(), "variance": out[1].t()}


def build(config: dict, traffic: dict, device) -> Entry:
    return Entry(config, traffic, device)
