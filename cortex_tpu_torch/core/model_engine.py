"""Model-engine interface + factor-graph data structures (L3).

Mirrors the reference's ``src/model_engine.jl``:

- :class:`Variable`, :class:`Factor`, :class:`Connection` structs
  (reference ``src/model_engine.jl:30-230``),
- the support trait and :class:`UnsupportedModelEngineError`
  (reference ``src/model_engine.jl:252-321``),
- the seven abstract accessors any graph-storage backend must implement
  (reference ``src/model_engine.jl:329-391``).

A model engine is *pluggable storage* for a bipartite factor graph; the
concrete default backend lives in :mod:`cortex_tpu_torch.core.graph`.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .signal import Signal
from .variants import create_inference_signal

__all__ = [
    "Variable",
    "Factor",
    "Connection",
    "UnsupportedModelEngineError",
    "is_engine_supported",
    "throw_if_engine_unsupported",
    "ENGINE_INTERFACE",
]

#: Names of the abstract accessors a model-engine backend must provide
#: (reference ``src/model_engine.jl:329-391``).
ENGINE_INTERFACE = (
    "get_variable",
    "get_factor",
    "get_variable_ids",
    "get_factor_ids",
    "get_connection",
    "get_connected_variable_ids",
    "get_connected_factor_ids",
)


class Variable:
    """A probabilistic variable (reference ``src/model_engine.jl:30-35``).

    Holds the variable's name/index, its marginal belief as a reactive signal,
    and *linked signals* recomputed whenever the marginal updates (e.g. joint
    marginals around factors).
    """

    __slots__ = ("name", "index", "marginal", "linked_signals")

    def __init__(
        self,
        name: str,
        index: Any = None,
        marginal: Optional[Signal] = None,
        linked_signals: Optional[List[Signal]] = None,
    ) -> None:
        self.name = name
        self.index = index
        self.marginal = marginal if marginal is not None else create_inference_signal()
        self.linked_signals: List[Signal] = (
            linked_signals if linked_signals is not None else []
        )

    def get_name(self) -> str:
        return self.name

    def get_index(self) -> Any:
        return self.index

    def get_marginal(self) -> Signal:
        return self.marginal

    def get_linked_signals(self) -> List[Signal]:
        return self.linked_signals

    def link_signal(self, signal: Signal) -> None:
        """Reference ``link_signal_to_variable!`` (``src/model_engine.jl:80-83``)."""
        self.linked_signals.append(signal)

    def __repr__(self) -> str:
        out = f"Variable(name = {self.name}"
        if self.index is not None:
            out += f", index = {self.index}"
        return out + ")"


class Factor:
    """A probabilistic factor (reference ``src/model_engine.jl:119-122``)."""

    __slots__ = ("functional_form", "local_marginals")

    def __init__(
        self,
        functional_form: Any,
        local_marginals: Optional[List[Signal]] = None,
    ) -> None:
        self.functional_form = functional_form
        self.local_marginals: List[Signal] = (
            local_marginals if local_marginals is not None else []
        )

    def get_functional_form(self) -> Any:
        return self.functional_form

    def get_local_marginals(self) -> List[Signal]:
        return self.local_marginals

    def add_local_marginal(self, local_marginal: Signal) -> None:
        """Reference ``add_local_marginal_to_factor!``
        (``src/model_engine.jl:150-153``)."""
        self.local_marginals.append(local_marginal)

    def __repr__(self) -> str:
        return f"Factor(functional_form = {self.functional_form})"


class Connection:
    """A variable–factor edge carrying the two directed message signals
    (reference ``src/model_engine.jl:181-186``)."""

    __slots__ = ("label", "index", "message_to_variable", "message_to_factor")

    def __init__(
        self,
        label: str,
        index: int = 0,
        message_to_variable: Optional[Signal] = None,
        message_to_factor: Optional[Signal] = None,
    ) -> None:
        self.label = label
        self.index = index
        self.message_to_variable = (
            message_to_variable
            if message_to_variable is not None
            else create_inference_signal()
        )
        self.message_to_factor = (
            message_to_factor
            if message_to_factor is not None
            else create_inference_signal()
        )

    def get_label(self) -> str:
        return self.label

    def get_index(self) -> int:
        return self.index

    def get_message_to_variable(self) -> Signal:
        return self.message_to_variable

    def get_message_to_factor(self) -> Signal:
        return self.message_to_factor

    def __repr__(self) -> str:
        out = f"Connection(label = {self.label}"
        if self.index != 0:
            out += f", index = {self.index}"
        return out + ")"


class UnsupportedModelEngineError(Exception):
    """Raised when using an unsupported model engine, optionally naming the
    missing accessor (reference ``src/model_engine.jl:252-266``)."""

    def __init__(self, model_engine: Any, missing_function: Optional[str] = None):
        self.model_engine = model_engine
        self.missing_function = missing_function
        if missing_function is None:
            msg = (
                f"The model engine of type `{type(model_engine).__name__}` "
                "is not supported."
            )
        else:
            msg = (
                f"The model engine of type `{type(model_engine).__name__}` does "
                f"not implement the function `{missing_function}`."
            )
        super().__init__(msg)


def is_engine_supported(engine: Any) -> bool:
    """Support trait (reference ``src/model_engine.jl:310``).

    An engine is supported when it implements the full accessor interface
    (duck-typed) or explicitly declares support via a truthy
    ``__cortex_engine_supported__`` attribute.
    """
    declared = getattr(engine, "__cortex_engine_supported__", None)
    if declared is not None:
        return bool(declared)
    return all(callable(getattr(engine, name, None)) for name in ENGINE_INTERFACE)


def throw_if_engine_unsupported(engine: Any) -> Any:
    """Reference ``throw_if_engine_unsupported`` (``src/model_engine.jl:319-321``)."""
    if not is_engine_supported(engine):
        raise UnsupportedModelEngineError(engine)
    for name in ENGINE_INTERFACE:
        if not callable(getattr(engine, name, None)):
            raise UnsupportedModelEngineError(engine, name)
    return engine
