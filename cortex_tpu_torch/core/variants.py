"""Inference-signal vocabulary — typed tags that drive rule dispatch.

Mirrors ``InferenceSignalVariants`` in the reference
(Cortex.jl's ``src/inference_signal.jl:8-142``).  Each inference signal
carries one of these variants; the inference engine dispatches the matching
``compute_*`` hook of the request processor on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

from .signal import Signal, UNDEF

__all__ = [
    "Unspecified",
    "MessageToFactor",
    "MessageToVariable",
    "ProductOfMessages",
    "IndividualMarginal",
    "JointMarginal",
    "InferenceSignalVariant",
    "create_inference_signal",
]


@dataclass(frozen=True)
class Unspecified:
    """Default variant; computation rules for it are undefined
    (reference ``src/inference_signal.jl:16``)."""


@dataclass(frozen=True)
class MessageToFactor:
    """A message from a variable to a factor
    (reference ``src/inference_signal.jl:29-32``)."""

    variable_id: int
    factor_id: int


@dataclass(frozen=True)
class MessageToVariable:
    """A message from a factor to a variable
    (reference ``src/inference_signal.jl:45-48``)."""

    variable_id: int
    factor_id: int


@dataclass(frozen=True)
class ProductOfMessages:
    """Partial product of messages for a variable over a sub-range of its
    connected factors — the segment-tree intermediate
    (reference ``src/inference_signal.jl:62-66``).

    ``range`` is a half-open ``(start, stop)`` 0-based index range into
    ``factors_connected_to_variable``.
    """

    variable_id: int
    range: Tuple[int, int]
    factors_connected_to_variable: Tuple[int, ...] = field(default_factory=tuple)


@dataclass(frozen=True)
class IndividualMarginal:
    """Marginal distribution of a single variable
    (reference ``src/inference_signal.jl:78-80``)."""

    variable_id: int


@dataclass(frozen=True)
class JointMarginal:
    """Joint marginal over multiple variables around a factor
    (reference ``src/inference_signal.jl:93-96``)."""

    factor_id: int
    variable_ids: Tuple[int, ...]


InferenceSignalVariant = Union[
    Unspecified,
    MessageToFactor,
    MessageToVariable,
    ProductOfMessages,
    IndividualMarginal,
    JointMarginal,
]


def create_inference_signal() -> Signal:
    """Create a signal with an :class:`Unspecified` variant
    (reference ``src/inference_signal.jl:140-142``)."""
    return Signal(UNDEF, Unspecified())
