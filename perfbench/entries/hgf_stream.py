"""The system under test for the streaming HGF: one stream a call,
``parallel.stream_filter(lambda st, c: hgf.filter(c, state=st,
method="fused", tracks=...), chunks, hgf.init_state((R,)))`` over the
batch's chunks, each a contiguous float32 ``(R, chunk)`` block in pinned
host memory.  Each chunk's copy to the card overlaps the kernel (K4) on the
chunk before; K4 carries each replica's state from chunk to chunk.  The
call's results are complete when the last chunk's K4 is."""

from __future__ import annotations

import torch

from perfbench import costs_hgf

PARAMS = ("kappa", "omega", "theta", "pi_u", "max_log_nu", "min_pi2", "max_mu2_step")


class Entry:
    replica_dim = 1  # a batch is chunk-major: (chunks, R, chunk)

    def __init__(self, config: dict, traffic: dict, device):
        from cortex_tpu_torch import parallel
        from cortex_tpu_torch.models import HGF

        self.model = HGF(**{name: config[name] for name in PARAMS})
        self.stream_filter = parallel.stream_filter
        self.device = torch.device(device)
        self.R, self.T = int(traffic["replicas"]), int(config["T"])
        self.chunk = int(config["chunk"])
        if self.T % self.chunk:
            raise ValueError(f"T = {self.T} is not a whole number of chunks of {self.chunk}")
        self.tracks = tuple(config["tracks"])  # float32, as u
        # Each call starts every replica from the zero state; K4 only reads it.
        self.init = self.model.init_state((self.R,), device=self.device)
        # One filtering update a replica-step.
        self.updates_per_call = self.R * self.T
        self.cost = costs_hgf.hgf_stream_call(self.R, self.T, self.chunk, len(self.tracks))

    def pack(self, ring):
        """The ring ``(n, R, T)`` as chunk-major host blocks ``(n, T / chunk,
        R, chunk)``, contiguous, in pinned memory when the entry runs on the
        card."""
        n, R, T = ring.shape
        chunked = ring.reshape(n, R, T // self.chunk, self.chunk).transpose(1, 2)
        host = torch.empty(chunked.shape, dtype=ring.dtype,
                           pin_memory=self.device.type == "cuda")
        return host.copy_(chunked)

    def inputs(self, batch):
        return {"u": batch.transpose(0, 1).reshape(batch.shape[1], -1)}

    def call(self, batch):
        model, tracks = self.model, self.tracks

        def step(state, chunk):
            return model.filter(chunk, state=state, method="fused", tracks=tracks)

        return self.stream_filter(step, batch.unbind(0), self.init, device=self.device)

    def results(self, out):
        state, trajectories = out
        res = {f"{name}_final": value for name, value in zip(("mu1", "pi1", "mu2", "pi2"), state)}
        for name, field in zip(("mu1", "pi1", "mu2", "pi2", "delta1"), trajectories[0]._fields):
            if name in self.tracks:
                res[name] = torch.cat([getattr(t, field) for t in trajectories], dim=1)
        return res


def build(config: dict, traffic: dict, device) -> Entry:
    return Entry(config, traffic, device)
