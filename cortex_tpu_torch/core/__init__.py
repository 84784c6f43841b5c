"""Core layers L1–L5: signals, variants, model engine, inference engine,
dependency resolvers."""

from .signal import (
    UNDEF,
    UNDEF_VARIANT,
    Signal,
    UndefValue,
    UndefVariant,
    compute_value,
)
from . import variants
from .variants import (
    IndividualMarginal,
    InferenceSignalVariant,
    JointMarginal,
    MessageToFactor,
    MessageToVariable,
    ProductOfMessages,
    Unspecified,
    create_inference_signal,
)
from .model_engine import (
    Connection,
    Factor,
    UnsupportedModelEngineError,
    Variable,
    is_engine_supported,
    throw_if_engine_unsupported,
)
from .graph import BipartiteFactorGraph
from .resolvers import (
    BeliefPropagationResolver,
    DependencyResolver,
    MeanFieldResolver,
    StructuredResolver,
)
from .engine import (
    InferenceEngine,
    InferenceEngineTracer,
    InferenceEngineWarning,
    InferenceRequest,
    InferenceRequestProcessor,
    InferenceRequestScanner,
    TracedInferenceExecution,
    TracedInferenceRequest,
    TracedInferenceRound,
    scan_inference_request,
)

__all__ = [
    "UNDEF",
    "UNDEF_VARIANT",
    "Signal",
    "UndefValue",
    "UndefVariant",
    "compute_value",
    "variants",
    "Unspecified",
    "MessageToFactor",
    "MessageToVariable",
    "ProductOfMessages",
    "IndividualMarginal",
    "JointMarginal",
    "InferenceSignalVariant",
    "create_inference_signal",
    "Variable",
    "Factor",
    "Connection",
    "UnsupportedModelEngineError",
    "is_engine_supported",
    "throw_if_engine_unsupported",
    "BipartiteFactorGraph",
    "DependencyResolver",
    "BeliefPropagationResolver",
    "MeanFieldResolver",
    "StructuredResolver",
    "InferenceEngine",
    "InferenceEngineWarning",
    "InferenceRequest",
    "InferenceRequestProcessor",
    "InferenceRequestScanner",
    "scan_inference_request",
    "InferenceEngineTracer",
    "TracedInferenceExecution",
    "TracedInferenceRound",
    "TracedInferenceRequest",
]
