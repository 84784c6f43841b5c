"""Inference engine (L4): orchestration, request processing, scheduling, tracing.

Mirrors the reference's ``src/inference_engine.jl``:

- :class:`InferenceEngine` wraps a model engine + dependency resolver +
  request processor + optional tracer + warnings (reference ``:53-90``),
- ``set_signals_variants`` stamps variants onto all signals (reference
  ``:228-247``),
- :func:`request_inference_for` marks dependencies of requested marginals and
  linked signals as potentially pending (reference ``:298-323``),
- :class:`InferenceRequestProcessor` is the five-hook user-rule interface
  (reference ``:331-477``) with variant-dispatching ``process`` (``:479-509``),
- :meth:`InferenceEngine.update_marginals` runs alternating forward/backward
  sweeps over the requested variables until quiescence, then a final round for
  marginals + linked signals (reference ``:559-632``),
- :func:`scan_inference_request` extracts the would-be schedule as data
  (reference ``:528-546``) — the hook for static compilation,
- the tracer hierarchy Request → Round → Execution with ns timings and value
  snapshots, zero-cost when disabled (reference ``:650-862``).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Union

from . import variants as V
from .model_engine import (
    Connection,
    Factor,
    Variable,
    throw_if_engine_unsupported,
)
from .signal import Signal
from ..utils import format_time_ns

__all__ = [
    "InferenceEngineWarning",
    "InferenceEngine",
    "InferenceRequest",
    "InferenceRequestProcessor",
    "InferenceRequestScanner",
    "scan_inference_request",
    "TracedInferenceExecution",
    "TracedInferenceRound",
    "TracedInferenceRequest",
    "InferenceEngineTracer",
]


class InferenceEngineWarning:
    """A soft diagnostic accumulated during engine construction or inference
    (reference ``src/inference_engine.jl:11-14``)."""

    __slots__ = ("description", "context")

    def __init__(self, description: str, context: Any) -> None:
        self.description = description
        self.context = context

    def __repr__(self) -> str:
        return f"InferenceEngineWarning({self.description!r}, {self.context!r})"


class InferenceRequest:
    """A request to update the marginals of a set of variables
    (reference ``src/inference_engine.jl:265-270``)."""

    __slots__ = ("engine", "variable_ids", "marginals", "readiness_status")

    def __init__(
        self,
        engine: "InferenceEngine",
        variable_ids: Sequence[int],
        marginals: List[Signal],
    ) -> None:
        self.engine = engine
        self.variable_ids = variable_ids
        self.marginals = marginals
        self.readiness_status = [False] * len(variable_ids)


class InferenceRequestProcessor:
    """User-rule interface: five hooks dispatched on signal variants
    (reference ``src/inference_engine.jl:331-477``).

    Subclass and override the ``compute_*`` hooks relevant to your model.  Each
    hook receives ``(engine, variant, signal, dependencies)`` and returns the
    new value for ``signal``.
    """

    def compute_message_to_variable(self, engine, variant, signal, dependencies):
        raise NotImplementedError(
            "compute_message_to_variable is not implemented for processor "
            f"of type {type(self).__name__}"
        )

    def compute_message_to_factor(self, engine, variant, signal, dependencies):
        raise NotImplementedError(
            "compute_message_to_factor is not implemented for processor "
            f"of type {type(self).__name__}"
        )

    def compute_individual_marginal(self, engine, variant, signal, dependencies):
        raise NotImplementedError(
            "compute_individual_marginal is not implemented for processor "
            f"of type {type(self).__name__}"
        )

    def compute_product_of_messages(self, engine, variant, signal, dependencies):
        raise NotImplementedError(
            "compute_product_of_messages is not implemented for processor "
            f"of type {type(self).__name__}"
        )

    def compute_joint_marginal(self, engine, variant, signal, dependencies):
        raise NotImplementedError(
            "compute_joint_marginal is not implemented for processor "
            f"of type {type(self).__name__}"
        )

    # Variant dispatch (reference src/inference_engine.jl:479-509).
    def process(
        self, engine: "InferenceEngine", variable_id: int, dependency: Signal
    ) -> None:
        def strategy(signal: Signal, dependencies: List[Signal]) -> Any:
            variant = signal.variant
            if isinstance(variant, V.MessageToVariable):
                return self.compute_message_to_variable(
                    engine, variant, signal, dependencies
                )
            if isinstance(variant, V.MessageToFactor):
                return self.compute_message_to_factor(
                    engine, variant, signal, dependencies
                )
            if isinstance(variant, V.IndividualMarginal):
                return self.compute_individual_marginal(
                    engine, variant, signal, dependencies
                )
            if isinstance(variant, V.ProductOfMessages):
                return self.compute_product_of_messages(
                    engine, variant, signal, dependencies
                )
            if isinstance(variant, V.JointMarginal):
                return self.compute_joint_marginal(
                    engine, variant, signal, dependencies
                )
            raise RuntimeError(f"Unprocessed signal variant: {signal.variant}")

        dependency.compute(strategy)


class InferenceRequestScanner(InferenceRequestProcessor):
    """A processor that *collects* pending signals instead of computing them —
    dry-run schedule extraction (reference ``src/inference_engine.jl:528-537``)."""

    def __init__(self) -> None:
        self.signals: List[Signal] = []

    def process(
        self, engine: "InferenceEngine", variable_id: int, dependency: Signal
    ) -> None:
        self.signals.append(dependency)


def _process_inference_request(
    processor: InferenceRequestProcessor,
    request: InferenceRequest,
    variable_id: int,
    marginal: Signal,
    trace: Optional[tuple] = None,
) -> bool:
    """Walk pending dependencies of ``marginal`` computing each pending signal
    found (reference ``src/inference_engine.jl:512-525``)."""

    def callback(dependency: Signal) -> bool:
        if dependency.is_pending():
            _trace_execution(
                trace,
                variable_id,
                dependency,
                lambda: processor.process(request.engine, variable_id, dependency),
            )
            return True
        return False

    return marginal.process_dependencies(callback, retry=True)


def scan_inference_request(request: InferenceRequest) -> List[Signal]:
    """Return all pending signals the request would compute, in traversal order
    (reference ``src/inference_engine.jl:540-546``)."""
    scanner = InferenceRequestScanner()
    for variable_id, marginal in zip(request.variable_ids, request.marginals):
        _process_inference_request(scanner, request, variable_id, marginal)
    return scanner.signals


class InferenceEngine:
    """Core orchestrator for message-passing inference
    (reference ``src/inference_engine.jl:53-90``).

    Parameters
    ----------
    model_engine:
        Any object implementing the model-engine accessor interface
        (e.g. :class:`~cortex_tpu_torch.core.graph.BipartiteFactorGraph`).
    dependency_resolver:
        Wires message/marginal dependency edges; defaults to the
        Belief-Propagation resolver.
    inference_request_processor:
        The rule set; defaults to a scanner (collects, computes nothing).
    prepare_signals_metadata / resolve_dependencies / trace:
        Same semantics as the reference constructor kwargs.
    """

    def __init__(
        self,
        model_engine: Any,
        dependency_resolver: Any = None,
        inference_request_processor: Optional[InferenceRequestProcessor] = None,
        *,
        prepare_signals_metadata: bool = True,
        resolve_dependencies: bool = True,
        trace: bool = False,
    ) -> None:
        from .resolvers import BeliefPropagationResolver  # cycle-free import

        self.model_engine = throw_if_engine_unsupported(model_engine)
        self.dependency_resolver = (
            dependency_resolver
            if dependency_resolver is not None
            else BeliefPropagationResolver()
        )
        self.inference_request_processor = (
            inference_request_processor
            if inference_request_processor is not None
            else InferenceRequestScanner()
        )
        self.tracer: Optional[InferenceEngineTracer] = (
            InferenceEngineTracer() if trace else None
        )
        self.warnings: List[InferenceEngineWarning] = []

        if prepare_signals_metadata:
            self.set_signals_variants()
        if resolve_dependencies:
            self.dependency_resolver.resolve_dependencies(self)

    # -- warnings / trace --------------------------------------------------
    def add_warning(self, description: str, context: Any) -> None:
        self.warnings.append(InferenceEngineWarning(description, context))

    def get_warnings(self) -> List[InferenceEngineWarning]:
        return self.warnings

    def get_trace(self) -> Optional["InferenceEngineTracer"]:
        return self.tracer

    # -- model-engine aliases (reference src/inference_engine.jl:139-205) --
    def get_model_engine(self):
        """Reference ``get_model_engine`` (``src/inference_engine.jl:119``)."""
        return self.model_engine

    def get_variable(self, variable_id: int) -> Variable:
        return self.model_engine.get_variable(variable_id)

    def get_factor(self, factor_id: int) -> Factor:
        return self.model_engine.get_factor(factor_id)

    def get_variable_ids(self):
        return self.model_engine.get_variable_ids()

    def get_factor_ids(self):
        return self.model_engine.get_factor_ids()

    def get_connection(self, variable_id: int, factor_id: int) -> Connection:
        return self.model_engine.get_connection(variable_id, factor_id)

    def get_connected_variable_ids(self, factor_id: int):
        return self.model_engine.get_connected_variable_ids(factor_id)

    def get_connected_factor_ids(self, variable_id: int):
        return self.model_engine.get_connected_factor_ids(variable_id)

    def get_message_to_variable(self, variable_id: int, factor_id: int) -> Signal:
        return self.get_connection(variable_id, factor_id).message_to_variable

    def get_message_to_factor(self, variable_id: int, factor_id: int) -> Signal:
        return self.get_connection(variable_id, factor_id).message_to_factor

    def get_variable_marginal(self, variable_id: int) -> Signal:
        return self.get_variable(variable_id).marginal

    # -- construction steps -----------------------------------------------
    def set_signals_variants(self) -> None:
        """Stamp IndividualMarginal / MessageToFactor / MessageToVariable
        variants onto all signals (reference ``src/inference_engine.jl:228-247``)."""
        for variable_id in self.get_variable_ids():
            variable = self.get_variable(variable_id)
            variable.marginal.set_variant(V.IndividualMarginal(variable_id))
        for factor_id in self.get_factor_ids():
            for variable_id in self.get_connected_variable_ids(factor_id):
                connection = self.get_connection(variable_id, factor_id)
                connection.message_to_factor.set_variant(
                    V.MessageToFactor(variable_id, factor_id)
                )
                connection.message_to_variable.set_variant(
                    V.MessageToVariable(variable_id, factor_id)
                )

    # -- requests ----------------------------------------------------------
    def request_inference_for(
        self, variable_ids: Union[int, Sequence[int]]
    ) -> InferenceRequest:
        """Mark the dependencies of each requested marginal and the variable's
        linked signals as potentially pending
        (reference ``src/inference_engine.jl:298-323``)."""
        if isinstance(variable_ids, int):
            variable_ids = (variable_ids,)
        marginals: List[Signal] = []
        for variable_id in variable_ids:
            variable = self.get_variable(variable_id)
            marginal = variable.marginal
            for dependency in marginal.get_dependencies():
                dependency.mark_potentially_pending()
            for linked_signal in variable.linked_signals:
                linked_signal.mark_potentially_pending()
            marginals.append(marginal)
        return InferenceRequest(self, variable_ids, marginals)

    # -- the sweep scheduler (reference src/inference_engine.jl:559-632) ---
    def update_marginals(self, variable_ids: Union[int, Sequence[int]]) -> None:
        """Update the marginals of ``variable_ids``: alternate forward/backward
        sweeps over the requested variables until a full pass processes zero
        signals, then compute the marginals and their linked signals."""
        if isinstance(variable_ids, int):
            variable_ids = (variable_ids,)

        request = self.request_inference_for(variable_ids)
        processor = self.inference_request_processor

        def run(request_trace: Optional[tuple]) -> None:
            n = len(variable_ids)
            forward = range(n)
            backward = range(n - 1, -1, -1)
            is_reverse = False
            should_continue = True

            while should_continue:
                current_order = backward if is_reverse else forward

                def round_body(round_trace: Optional[tuple]) -> bool:
                    processed_any = False
                    for i in current_order:
                        if not request.readiness_status[i]:
                            variable_id = variable_ids[i]
                            marginal = request.marginals[i]
                            processed = _process_inference_request(
                                processor, request, variable_id, marginal,
                                trace=round_trace,
                            )
                            if marginal.is_pending():
                                request.readiness_status[i] = True
                            processed_any = processed_any or processed
                    return processed_any

                should_continue = _trace_round(request_trace, round_body)
                is_reverse = not is_reverse

            def final_round(round_trace: Optional[tuple]) -> bool:
                for variable_id, marginal in zip(request.variable_ids, request.marginals):
                    if marginal.is_pending():
                        _trace_execution(
                            round_trace,
                            variable_id,
                            marginal,
                            lambda m=marginal, v=variable_id: processor.process(
                                self, v, m
                            ),
                        )
                    for linked_signal in self.get_variable(variable_id).linked_signals:
                        if not linked_signal.is_pending():
                            continue
                        _trace_execution(
                            round_trace,
                            variable_id,
                            linked_signal,
                            lambda s=linked_signal, v=variable_id: processor.process(
                                self, v, s
                            ),
                        )
                return False

            _trace_round(request_trace, final_round)

        _trace_request(self.tracer, self, request, run)

    def __repr__(self) -> str:
        return f"InferenceEngine(trace = {'true' if self.tracer else 'false'})"


## -- Inference tracing (reference src/inference_engine.jl:650-862) --------


class TracedInferenceExecution:
    """A record of a single signal computation
    (reference ``src/inference_engine.jl:650-657``)."""

    __slots__ = (
        "engine",
        "variable_id",
        "signal",
        "total_time_ns",
        "value_before_execution",
        "value_after_execution",
    )

    def __init__(self, engine, variable_id, signal, total_time_ns, before, after):
        self.engine = engine
        self.variable_id = variable_id
        self.signal = signal
        self.total_time_ns = total_time_ns
        self.value_before_execution = before
        self.value_after_execution = after

    def __repr__(self) -> str:
        engine = self.engine
        variable_data = engine.get_variable(self.variable_id)
        variant = self.signal.variant
        if isinstance(variant, V.MessageToVariable):
            v_data = engine.get_variable(variant.variable_id)
            f_data = engine.get_factor(variant.factor_id)
            variant_str = f"MessageToVariable(from = {f_data}, to = {v_data})"
        elif isinstance(variant, V.MessageToFactor):
            v_data = engine.get_variable(variant.variable_id)
            f_data = engine.get_factor(variant.factor_id)
            variant_str = f"MessageToFactor(from = {v_data}, to = {f_data})"
        elif isinstance(variant, V.ProductOfMessages):
            variant_str = "ProductOfMessages(?)"
        elif isinstance(variant, V.IndividualMarginal):
            v_data = engine.get_variable(variant.variable_id)
            variant_str = f"IndividualMarginal({v_data})"
        elif isinstance(variant, V.JointMarginal):
            variant_str = "JointMarginal(?)"
        else:
            variant_str = f"Unknown({variant!r})"
        return (
            f"TracedInferenceExecution(for = {variable_data}, "
            f"variant = {variant_str}), "
            f"total_time = {format_time_ns(self.total_time_ns)}, "
            f"value_before_execution = {self.value_before_execution}, "
            f"value_after_execution = {self.value_after_execution})"
        )


class TracedInferenceRound:
    """A record of one sweep round
    (reference ``src/inference_engine.jl:711-715``)."""

    __slots__ = ("engine", "total_time_ns", "executions")

    def __init__(self, engine, total_time_ns, executions):
        self.engine = engine
        self.total_time_ns = total_time_ns
        self.executions = executions

    def __repr__(self) -> str:
        lines = [
            f"TracedInferenceRound(total_time = {format_time_ns(self.total_time_ns)},"
            f" executions = ["
        ]
        for e in self.executions:
            lines.append(f"  {e!r}")
        lines.append("])")
        return "\n".join(lines)


class TracedInferenceRequest:
    """A complete record of an inference request execution
    (reference ``src/inference_engine.jl:729-734``)."""

    __slots__ = ("engine", "total_time_ns", "request", "rounds")

    def __init__(self, engine, total_time_ns, request, rounds):
        self.engine = engine
        self.total_time_ns = total_time_ns
        self.request = request
        self.rounds = rounds

    def __repr__(self) -> str:
        lines = [
            f"TracedInferenceRequest(total_time = {format_time_ns(self.total_time_ns)},"
            f" rounds = ["
        ]
        for r in self.rounds:
            lines.append(f"  {r!r}")
        lines.append("])")
        return "\n".join(lines)


class InferenceEngineTracer:
    """Opt-in tracer recording Request → Round → Execution with ns timings and
    value before/after snapshots (reference ``src/inference_engine.jl:750-754``)."""

    def __init__(self) -> None:
        self.inference_requests: List[TracedInferenceRequest] = []

    def __repr__(self) -> str:
        lines = ["InferenceEngineTracer(inference_requests = ["]
        for r in self.inference_requests:
            lines.append(f" {r!r}")
        lines.append("])")
        return "\n".join(lines)


def _trace_request(tracer, engine, request, f) -> None:
    """Wrapper with a no-op fast path (reference ``:757-785``)."""
    if tracer is None:
        f(None)
        return
    rounds: List[TracedInferenceRound] = []
    begin_ns = time.perf_counter_ns()
    f((engine, tracer, rounds))
    total_ns = time.perf_counter_ns() - begin_ns
    tracer.inference_requests.append(
        TracedInferenceRequest(engine, total_ns, request, rounds)
    )


def _trace_round(trace, f):
    """Wrapper with a no-op fast path (reference ``:792-823``).  ``f`` receives
    the round trace and returns a value passed through."""
    if trace is None:
        return f(None)
    engine, tracer, rounds = trace
    executions: List[TracedInferenceExecution] = []
    begin_ns = time.perf_counter_ns()
    result = f((engine, tracer, executions))
    total_ns = time.perf_counter_ns() - begin_ns
    if executions:
        rounds.append(TracedInferenceRound(engine, total_ns, executions))
    return result


def _trace_execution(trace, variable_id, dependency: Signal, f) -> None:
    """Wrapper with a no-op fast path (reference ``:825-862``)."""
    if trace is None:
        f()
        return
    engine, tracer, executions = trace
    before = dependency.get_value()
    begin_ns = time.perf_counter_ns()
    f()
    total_ns = time.perf_counter_ns() - begin_ns
    after = dependency.get_value()
    executions.append(
        TracedInferenceExecution(engine, variable_id, dependency, total_ns, before, after)
    )
