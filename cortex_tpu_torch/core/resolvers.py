"""Dependency resolvers (L5): wire message/marginal dependency edges.

A resolver decides, for a given factorization of the posterior, which signals
each message/marginal depends on.  Three resolvers ship with the framework:

- :class:`BeliefPropagationResolver` — sum-product wiring; the reference's
  ``DefaultDependencyResolver`` (Cortex.jl's ``src/dependencies.jl:1-173``)
  including the degree-1 shortcut, the direct all-pairs wiring for degree ≤ 5,
  and the balanced segment tree of ``ProductOfMessages`` intermediates giving
  O(n log n) partial products for high-degree variables,
- :class:`MeanFieldResolver` — naive mean-field VMP wiring: messages depend
  (weakly) on the *marginals* of the other connected variables (modeled on the
  reference's test resolver, ``test/inference_engine_tests.jl:597-621``),
- :class:`StructuredResolver` — structured VMP wiring with joint marginals
  over variable clusters around selected factors (modeled on
  ``test/inference_engine_tests.jl:811-907``).

Weak dependencies are what make VMP order-robust: a stale-but-computed marginal
may participate in an update without re-triggering it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from . import variants as V
from .signal import Signal

__all__ = [
    "DependencyResolver",
    "BeliefPropagationResolver",
    "MeanFieldResolver",
    "StructuredResolver",
]


class DependencyResolver:
    """Abstract base: resolve dependencies for every factor, then every
    variable (reference ``src/dependencies.jl:5-15``)."""

    def resolve_dependencies(self, engine) -> None:
        for factor_id in engine.get_factor_ids():
            self.resolve_factor_dependencies(engine, factor_id)
        for variable_id in engine.get_variable_ids():
            self.resolve_variable_dependencies(engine, variable_id)

    def resolve_factor_dependencies(self, engine, factor_id: int) -> None:
        raise NotImplementedError

    def resolve_variable_dependencies(self, engine, variable_id: int) -> None:
        raise NotImplementedError


class BeliefPropagationResolver(DependencyResolver):
    """Sum-product (BP) wiring — the default resolver."""

    def resolve_factor_dependencies(self, engine, factor_id: int) -> None:
        """Each outbound message ``f → v1`` depends on all inbound messages
        ``v2 → f`` with ``v2 != v1`` (reference ``src/dependencies.jl:17-31``)."""
        variable_ids = list(engine.get_connected_variable_ids(factor_id))
        for v1 in variable_ids:
            out_msg = engine.get_message_to_variable(v1, factor_id)
            for v2 in variable_ids:
                if v1 != v2:
                    out_msg.add_dependency(engine.get_message_to_factor(v2, factor_id))

    def resolve_variable_dependencies(self, engine, variable_id: int) -> None:
        """Variable-side wiring (reference ``src/dependencies.jl:33-126``).

        - degree 0 → warning ("dangling" variable),
        - degree 1 → the marginal is the single inbound message,
        - degree ≤ 5 → direct all-pairs wiring (typical for state-space models),
        - degree > 5 → balanced segment tree of ``ProductOfMessages``
          intermediates; outbound messages depend on the complementary
          subtree, giving O(n log n) partial products.

        Outbound ``v → f`` messages only get dependencies if someone listens to
        them (reference ``:73,107,117``).
        """
        factor_ids = list(engine.get_connected_factor_ids(variable_id))
        marginal = engine.get_variable_marginal(variable_id)
        nfactors = len(factor_ids)

        if nfactors == 0:
            engine.add_warning("Variable has no connected factors", variable_id)
            return

        if nfactors < 2:
            marginal.add_dependency(
                engine.get_message_to_variable(variable_id, factor_ids[0]),
                intermediate=True,
            )
            return

        if nfactors <= 5:
            for factor in factor_ids:
                message_from_factor = engine.get_message_to_variable(
                    variable_id, factor
                )
                marginal.add_dependency(message_from_factor, intermediate=True)
                message_to_factor = engine.get_message_to_factor(variable_id, factor)
                if message_to_factor.get_listeners():
                    for another_factor in factor_ids:
                        if another_factor != factor:
                            message_to_factor.add_dependency(
                                engine.get_message_to_variable(
                                    variable_id, another_factor
                                ),
                                intermediate=True,
                            )
            return

        middle = nfactors // 2
        left_range = (0, middle)
        right_range = (middle, nfactors)

        # One shared tuple for every ProductOfMessages variant below: building
        # it per tree node would copy the full factor list at each of the
        # ~2n nodes — O(n^2) for high-degree variables (measured as a 300s
        # build at a 50k-degree star in benchmarks/compiler_scale_bench.py).
        factors_tuple = tuple(factor_ids)
        left_dep = _form_segment_tree(
            engine, left_range, factor_ids, variable_id, factors_tuple
        )
        right_dep = _form_segment_tree(
            engine, right_range, factor_ids, variable_id, factors_tuple
        )

        for left_factor in factor_ids[left_range[0] : left_range[1]]:
            message_to_left = engine.get_message_to_factor(variable_id, left_factor)
            if message_to_left.get_listeners():
                message_to_left.add_dependency(right_dep, intermediate=True)

        for right_factor in factor_ids[right_range[0] : right_range[1]]:
            message_to_right = engine.get_message_to_factor(variable_id, right_factor)
            if message_to_right.get_listeners():
                message_to_right.add_dependency(left_dep, intermediate=True)

        marginal.add_dependency(left_dep, intermediate=True)
        marginal.add_dependency(right_dep, intermediate=True)


def _form_segment_tree(
    engine,
    rng: tuple,
    factor_ids: Sequence[int],
    variable_id: int,
    factors_tuple: tuple,
) -> Signal:
    """Build a balanced binary tree of ``ProductOfMessages`` intermediates over
    ``factor_ids[rng[0]:rng[1]]`` (reference ``src/dependencies.jl:128-173``).

    ``rng`` is a 0-based half-open range.  Each outbound message within one
    half depends on the *other* half's subtree root, so any exclusion product
    "all but factor k" is available in O(log n) hops.
    """
    start, stop = rng
    n = stop - start
    assert n >= 1
    if n == 1:
        return engine.get_message_to_variable(variable_id, factor_ids[start])

    middle = start + n // 2
    left_range = (start, middle)
    right_range = (middle, stop)

    left_dep = _form_segment_tree(
        engine, left_range, factor_ids, variable_id, factors_tuple
    )
    right_dep = _form_segment_tree(
        engine, right_range, factor_ids, variable_id, factors_tuple
    )

    for left_factor in factor_ids[left_range[0] : left_range[1]]:
        message_to_left = engine.get_message_to_factor(variable_id, left_factor)
        if message_to_left.get_listeners():
            message_to_left.add_dependency(right_dep, intermediate=True)

    for right_factor in factor_ids[right_range[0] : right_range[1]]:
        message_to_right = engine.get_message_to_factor(variable_id, right_factor)
        if message_to_right.get_listeners():
            message_to_right.add_dependency(left_dep, intermediate=True)

    intermediate = left_dep.new_sibling()
    intermediate.set_variant(
        V.ProductOfMessages(variable_id, (start, stop), factors_tuple)
    )
    intermediate.add_dependency(left_dep, intermediate=True)
    intermediate.add_dependency(right_dep, intermediate=True)
    return intermediate


class MeanFieldResolver(DependencyResolver):
    """Naive mean-field VMP wiring (modeled on the reference's test resolver,
    ``test/inference_engine_tests.jl:597-621``).

    Variable side: the marginal depends on all inbound messages (intermediate).
    Factor side: each outbound message ``f → v1`` depends *weakly* on the
    marginals of the other connected variables — weak because a stale marginal
    may be used without re-triggering the update.
    """

    def resolve_variable_dependencies(self, engine, variable_id: int) -> None:
        marginal = engine.get_variable_marginal(variable_id)
        for factor_id in engine.get_connected_factor_ids(variable_id):
            marginal.add_dependency(
                engine.get_message_to_variable(variable_id, factor_id),
                intermediate=True,
            )

    def resolve_factor_dependencies(self, engine, factor_id: int) -> None:
        variable_ids = list(engine.get_connected_variable_ids(factor_id))
        for v1 in variable_ids:
            msg = engine.get_message_to_variable(v1, factor_id)
            for v2 in variable_ids:
                if v1 != v2:
                    msg.add_dependency(
                        engine.get_variable_marginal(v2), weak=True
                    )


class StructuredResolver(DependencyResolver):
    """Structured VMP wiring with joint marginals over variable clusters
    (modeled on ``test/inference_engine_tests.jl:811-907``).

    Parameters
    ----------
    mean_field_predicate:
        ``(engine, factor_id) -> bool``; factors for which it returns True get
        mean-field wiring (weak deps on other variables' marginals).  Others
        get structured wiring with per-cluster joint marginals.
    cluster_fn:
        ``(engine, factor_id) -> List[List[int]]`` grouping the factor's
        connected variables into clusters.  Defaults to grouping by variable
        name (so ``x[i]`` and ``x[i+1]`` around a transition factor share a
        joint marginal).
    """

    def __init__(
        self,
        mean_field_predicate: Optional[Callable[[Any, int], bool]] = None,
        cluster_fn: Optional[Callable[[Any, int], List[List[int]]]] = None,
    ) -> None:
        self.mean_field_predicate = mean_field_predicate or (lambda e, f: False)
        self.cluster_fn = cluster_fn or _cluster_by_name

    def resolve_variable_dependencies(self, engine, variable_id: int) -> None:
        BeliefPropagationResolver().resolve_variable_dependencies(engine, variable_id)

    def resolve_factor_dependencies(self, engine, factor_id: int) -> None:
        if self.mean_field_predicate(engine, factor_id):
            MeanFieldResolver().resolve_factor_dependencies(engine, factor_id)
            return

        clusters = self.cluster_fn(engine, factor_id)

        # One dependency per cluster: the marginal for singletons, a fresh
        # JointMarginal signal for multi-variable clusters.
        deps: List[Signal] = []
        for cluster in clusters:
            if len(cluster) == 1:
                deps.append(engine.get_variable_marginal(cluster[0]))
            else:
                joint = engine.get_variable_marginal(cluster[0]).new_sibling()
                joint.set_variant(V.JointMarginal(factor_id, tuple(cluster)))
                for v_id in cluster:
                    engine.get_variable(v_id).link_signal(joint)
                    engine.get_factor(factor_id).add_local_marginal(joint)
                    joint.add_dependency(
                        engine.get_message_to_factor(v_id, factor_id), weak=True
                    )
                deps.append(joint)

        # Joint marginals depend weakly on the other clusters' dependencies.
        for d1 in deps:
            if isinstance(d1.variant, V.JointMarginal):
                for d2 in deps:
                    if d1 is not d2:
                        d1.add_dependency(d2, weak=True)

        for index, cluster in enumerate(clusters):
            # Within a cluster: BP-style message wiring.
            for m1 in cluster:
                msg_to_var = engine.get_message_to_variable(m1, factor_id)
                for m2 in cluster:
                    if m1 != m2:
                        msg_to_var.add_dependency(
                            engine.get_message_to_factor(m2, factor_id)
                        )
                # Across clusters: weak dependency on the other cluster's
                # joint/individual marginal.
                for another_index, another_dep in enumerate(deps):
                    if index != another_index:
                        msg_to_var.add_dependency(another_dep, weak=True)


def _cluster_by_name(engine, factor_id: int) -> List[List[int]]:
    """Group a factor's connected variables by variable name, preserving
    first-seen order (matches the reference test's clustering,
    ``test/inference_engine_tests.jl:838-849``)."""
    clusters: Dict[str, List[int]] = {}
    for variable_id in engine.get_connected_variable_ids(factor_id):
        name = engine.get_variable(variable_id).name
        clusters.setdefault(name, []).append(variable_id)
    return list(clusters.values())
