"""The canonical LGSSM chain as a *factor graph* (the generic-compiler path).

This is the flagship model of the whole framework: the reference's 100-step
chain SSM smoothed by sum-product Belief Propagation
(``test/inference_engine_tests.jl:379-488``), expressed as a
:class:`~cortex_tpu_torch.core.graph.BipartiteFactorGraph` and executed through
:class:`~cortex_tpu_torch.compile.CompiledInference` — the chain-lowering pass
rerolls the unrolled schedule into scan segments, so the generic
factor-graph program runs the same recursion as the hand-written smoother in
:mod:`cortex_tpu_torch.ops.chains`.  The counterpart of
``cortex_tpu/models/lgssm_graph.py``.
"""

from __future__ import annotations

import torch

from ..compile import BatchedProcessor
from ..core.engine import InferenceEngine, InferenceRequestProcessor
from ..core.graph import BipartiteFactorGraph
from ..core.model_engine import Connection, Factor, Variable
from ..dists import from_mean_variance

__all__ = [
    "LGSSMChainBatched",
    "LGSSMChainDynamic",
    "ScalarNormal",
    "make_chain_graph",
]


class LGSSMChainBatched(BatchedProcessor):
    """Batched sum-product rules for the unit-parameter chain SSM
    (reference rules: ``test/inference_engine_tests.jl:415-432``): likelihood
    messages lift raw observations to ``N(y, 1)``; transition messages add
    unit process variance; products/marginals use the default
    information-form reduction."""

    def compute_message_to_variable(self, engine, variants, dep_values):
        form = engine.get_factor(variants[0].factor_id).functional_form
        v = dep_values[0]
        if form == "likelihood":
            return from_mean_variance(v, torch.ones_like(v))
        if form == "transition":
            return from_mean_variance(v.mean, v.variance + 1.0)
        raise RuntimeError(f"Unknown functional form: {form}")


class ScalarNormal:
    """Pure-Python scalar Gaussian (mean/variance) for the dynamic-engine
    path — the package's stand-in for the reference's ``NormalMeanVariance``
    test distribution (``test/runtests.jl:17-101``)."""

    __slots__ = ("mean", "variance")

    def __init__(self, mean: float, variance: float) -> None:
        self.mean = mean
        self.variance = variance

    def __mul__(self, other: "ScalarNormal") -> "ScalarNormal":
        # Information-form product (test/runtests.jl:40-46).
        w = 1.0 / self.variance + 1.0 / other.variance
        xi = self.mean / self.variance + other.mean / other.variance
        return ScalarNormal(xi / w, 1.0 / w)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ScalarNormal(mean={self.mean}, variance={self.variance})"


class LGSSMChainDynamic(InferenceRequestProcessor):
    """Scalar per-signal rules for the dynamic reactive engine on the chain
    graph — the reference-architecture baseline the compiled path is judged
    against (dynamic rule dispatch: ``src/inference_engine.jl:479-509``)."""

    def compute_message_to_variable(self, engine, variant, signal, dependencies):
        value = dependencies[0].get_value()
        if isinstance(value, (int, float)):
            return ScalarNormal(float(value), 1.0)  # likelihood lift
        return ScalarNormal(value.mean, value.variance + 1.0)  # transition

    def _product(self, engine, variant, signal, dependencies):
        out = dependencies[0].get_value()
        for d in dependencies[1:]:
            out = out * d.get_value()
        return out

    compute_individual_marginal = _product
    compute_product_of_messages = _product
    compute_message_to_factor = _product


def make_chain_graph(n: int, processor: InferenceRequestProcessor = None):
    """Build the n-step chain SSM factor graph: latent ``x_0..x_{n-1}``,
    observed ``y_i — likelihood_i — x_i``, transitions ``x_i — x_{i+1}``
    (reference model construction: ``test/inference_engine_tests.jl:436-462``).

    Returns ``(engine, x, y, likelihood)`` with a BP-resolved
    :class:`InferenceEngine`; observations enter as
    ``("message_to_factor", y[i], likelihood[i])`` inputs.
    """
    g = BipartiteFactorGraph()
    x = [g.add_variable(Variable(name="x", index=(i,))) for i in range(n)]
    y = [g.add_variable(Variable(name="y", index=(i,))) for i in range(n)]
    likelihood = [
        g.add_factor(Factor(functional_form="likelihood")) for _ in range(n)
    ]
    transition = [
        g.add_factor(Factor(functional_form="transition")) for _ in range(n - 1)
    ]
    for i in range(n):
        g.add_edge(y[i], likelihood[i], Connection(label="out"))
        g.add_edge(x[i], likelihood[i], Connection(label="out"))
    for i in range(n - 1):
        g.add_edge(x[i], transition[i], Connection(label="out"))
        g.add_edge(x[i + 1], transition[i], Connection(label="in"))
    engine = InferenceEngine(
        model_engine=g, inference_request_processor=processor
    )
    return engine, x, y, likelihood
