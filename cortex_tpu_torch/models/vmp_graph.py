"""The canonical mean-field VMP SSM as a *factor graph* (generic compiler).

The reference's mean-field gold model — a chain SSM with UNKNOWN process and
observation precisions, solved by variational message passing with a
mean-field resolver (``test/inference_engine_tests.jl:593-805``) — expressed
as a :class:`~cortex_tpu_torch.core.graph.BipartiteFactorGraph` and executed
through :class:`~cortex_tpu_torch.compile.CompiledInference` with role-refined
rule groups.  This is the model that exercises the weak-edge/steady-state
machinery of the compiled path (the LGSSM chain exercises pure BP).  The
counterpart of ``cortex_tpu/models/vmp_graph.py``.
"""

from __future__ import annotations

import torch

from ..compile import BatchedProcessor
from ..core.engine import InferenceEngine
from ..core.graph import BipartiteFactorGraph
from ..core.model_engine import Connection, Factor, Variable
from ..core.resolvers import MeanFieldResolver
from ..dists import Gamma, from_mean_precision
from ..utils.tree import as_float32_tensor

__all__ = ["MeanFieldSSMBatched", "make_mean_field_ssm_graph"]


class MeanFieldSSMBatched(BatchedProcessor):
    """Batched mean-field rules, routed on the role-refined group key
    (the compiled analogue of the reference's name-dispatching processor,
    ``test/inference_engine_tests.jl:653-696``)."""

    def dispatch(self, engine, group, dep_values):
        kind = group.key[0]
        if kind == "IndividualMarginal":
            return self.compute_individual_marginal(engine, None, dep_values)
        assert kind == "MessageToVariable"
        own_role, dep_roles = group.key[3]

        if dep_roles == ("y", "obsnoise"):
            # Message to x from likelihood: N(y, E[tau_obs]).
            y, q_obs = dep_values
            return from_mean_precision(y, q_obs.mean)
        if dep_roles == ("y", "x"):
            # Message to obsnoise: Gamma(3/2, rate=(var+PE^2)/2).
            y, q_x = dep_values
            rate = 0.5 * (q_x.variance + (y - q_x.mean) ** 2)
            return Gamma(torch.full_like(rate, 1.5), rate)
        if dep_roles == ("x", "ssnoise"):
            # Message to x from transition: N(mean(q_x_other), E[tau_ss]).
            q_x, q_ss = dep_values
            return from_mean_precision(q_x.mean, q_ss.mean)
        if dep_roles == ("x", "x"):
            # Message to ssnoise.
            q1, q2 = dep_values
            rate = 0.5 * (q1.variance + q2.variance + (q1.mean - q2.mean) ** 2)
            return Gamma(torch.full_like(rate, 1.5), rate)
        raise RuntimeError(f"Unknown group roles: {group.key}")


def set_ssm_initials(engine, x, y, ssnoise, obsnoise, observations, device) -> None:
    """The compile-time state of the mean-field and structured SSMs on
    ``device``: Gamma(1, 1) noise precisions, N(0, 1) states and the frozen
    ``y`` marginals ``observations[i]`` (float32 where given as Python or
    numpy values, as the JAX package makes them)."""
    for noise in (ssnoise, obsnoise):
        engine.get_variable_marginal(noise).set_value(
            Gamma(as_float32_tensor(1.0, device), as_float32_tensor(1.0, device))
        )
    for i in range(len(x)):
        engine.get_variable_marginal(x[i]).set_value(
            from_mean_precision(0.0, 1.0, device=device)
        )
        engine.get_variable_marginal(y[i]).set_value(as_float32_tensor(observations[i], device))


def make_mean_field_ssm_graph(n, observations, device="cuda"):
    """Build the n-step mean-field SSM: chain states ``x``, observed ``y``,
    shared ``ssnoise``/``obsnoise`` precision variables; likelihood factors
    ``(y_i, x_i, obsnoise)`` and transition factors ``(x_i, x_{i+1},
    ssnoise)``.  ``observations[i]`` may be scalars or (replica-batched)
    arrays — they become the frozen ``y`` marginals.  The initial state's
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
    engine = InferenceEngine(model_engine=g, dependency_resolver=MeanFieldResolver())
    set_ssm_initials(engine, x, y, ssnoise, obsnoise, observations, device)
    return engine, x, y, ssnoise, obsnoise
