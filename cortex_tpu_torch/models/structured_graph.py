"""The canonical structured VMP SSM as a *factor graph* (generic compiler).

The reference's structured gold model — pairwise joint marginals (2x2
Gaussians) over transition clusters, mean-field likelihoods, Gamma
precision posteriors (``test/inference_engine_tests.jl:807-1147``) —
expressed as a :class:`~cortex_tpu_torch.core.graph.BipartiteFactorGraph`
with a :class:`~cortex_tpu_torch.core.resolvers.StructuredResolver` and
executed through :class:`~cortex_tpu_torch.compile.CompiledInference`: all
n-1 joint-marginal updates collapse into ONE batched 2x2 information-form
assembly per sweep.  The counterpart of
``cortex_tpu/models/structured_graph.py``.
"""

from __future__ import annotations

import torch

from ..compile import BatchedProcessor
from ..core.engine import InferenceEngine
from ..core.graph import BipartiteFactorGraph
from ..core.model_engine import Connection, Factor, Variable
from ..core.resolvers import StructuredResolver
from ..dists import Gamma, MvGaussian, from_mean_precision
from .vmp_graph import set_ssm_initials

__all__ = ["StructuredSSMBatched", "make_structured_ssm_graph"]


class StructuredSSMBatched(BatchedProcessor):
    """Batched structured-VMP rules (cf. the dynamic
    ``SSMStructuredProcessor``, ``test/inference_engine_tests.jl:917-1035``)."""

    def dispatch(self, engine, group, dep_values):
        kind = group.key[0]
        if kind in ("IndividualMarginal", "MessageToFactor", "ProductOfMessages"):
            return self.compute_individual_marginal(engine, None, dep_values)
        if kind == "JointMarginal":
            # deps: (msg_to_factor x_i, msg_to_factor x_{i+1}, q(ssnoise)).
            msg1, msg2, q_ss = dep_values
            xi1, w1 = msg1.xi, msg1.w
            xi2, w2 = msg2.xi, msg2.w
            w_bar = q_ss.mean
            # Information-form 2x2 joint: W = [[w1+wb, -wb], [-wb, w2+wb]].
            W = torch.stack(
                [
                    torch.stack([w1 + w_bar, -w_bar], dim=-1),
                    torch.stack([-w_bar, w2 + w_bar], dim=-1),
                ],
                dim=-2,
            )
            xi = torch.stack([xi1, xi2], dim=-1)
            return MvGaussian(xi, W)
        assert kind == "MessageToVariable"
        own_role, dep_roles = group.key[3]
        form = engine.get_factor(group.steps[0].variant.factor_id).functional_form

        if form == "likelihood":
            if dep_roles == ("y", "obsnoise"):
                y, q_obs = dep_values
                return from_mean_precision(y, q_obs.mean)
            if dep_roles == ("y", "x"):
                y, q_x = dep_values
                rate = 0.5 * (q_x.variance + (y - q_x.mean) ** 2)
                return Gamma(torch.full_like(rate, 1.5), rate)
            raise RuntimeError(f"likelihood roles {dep_roles}")
        if form == "transition":
            if own_role == "ssnoise":
                # Message to ssnoise from the joint marginal.
                (jm,) = dep_values
                cov = jm.cov
                m = jm.mean
                rate = 0.5 * (
                    cov[..., 0, 0]
                    - cov[..., 0, 1]
                    - cov[..., 1, 0]
                    + cov[..., 1, 1]
                    + (m[..., 0] - m[..., 1]) ** 2
                )
                return Gamma(torch.full_like(rate, 1.5), rate)
            # Message to x: from the other x's inbound message + q(ssnoise):
            # N(mean(msg), 1/(var(msg) + 1/E[tau])).
            msg, q_ss = dep_values
            prec = 1.0 / (msg.variance + 1.0 / q_ss.mean)
            return from_mean_precision(msg.mean, prec)
        raise RuntimeError(f"Unknown group: {group.key}")


def make_structured_ssm_graph(n, observations, device="cuda"):
    """Build the n-step structured SSM: chain states ``x``, observed ``y``,
    shared ``ssnoise``/``obsnoise`` precision variables; the
    :class:`~cortex_tpu_torch.core.resolvers.StructuredResolver` builds
    pairwise joint marginals over transition clusters and mean-field wiring
    for the likelihoods.  ``observations[i]`` may be scalars or
    replica-batched arrays (frozen ``y`` marginals).  The initial state's
    tensors live on ``device`` (the card unless the caller asks for
    another).

    Returns ``(engine, x, y, ssnoise, obsnoise)`` (variable-id lists)."""
    g = BipartiteFactorGraph()
    ssnoise = g.add_variable(Variable(name="ssnoise"))
    obsnoise = g.add_variable(Variable(name="obsnoise"))
    x = [g.add_variable(Variable(name="x", index=(i,))) for i in range(n)]
    y = [g.add_variable(Variable(name="y", index=(i,))) for i in range(n)]
    likelihood = [g.add_factor(Factor(functional_form="likelihood")) for _ in range(n)]
    transition = [g.add_factor(Factor(functional_form="transition")) for _ in range(n - 1)]
    for i in range(n):
        g.add_edge(y[i], likelihood[i], Connection(label="out"))
        g.add_edge(x[i], likelihood[i], Connection(label="out"))
        g.add_edge(obsnoise, likelihood[i], Connection(label="out"))
    for i in range(n - 1):
        g.add_edge(x[i], transition[i], Connection(label="out"))
        g.add_edge(x[i + 1], transition[i], Connection(label="in"))
        g.add_edge(ssnoise, transition[i], Connection(label="out"))

    resolver = StructuredResolver(
        mean_field_predicate=lambda e, fid: e.get_factor(fid).get_functional_form()
        == "likelihood"
    )
    engine = InferenceEngine(model_engine=g, dependency_resolver=resolver)
    set_ssm_initials(engine, x, y, ssnoise, obsnoise, observations, device)
    return engine, x, y, ssnoise, obsnoise
