"""Static schedule compiler: signal DAG → phased, type-batched tensor programs."""

from ..utils import spans as _spans

# The subpackage's imports: a set-up span of the process.
with _spans.setup_span("setup.import"):
    from .schedule import (
        ComputeStep,
        PhaseGroup,
        StaticSchedule,
        dep_role_key,
        extract_schedule,
    )
    from .lowering import (
        LoweredPlan,
        ScanClass,
        ScanSegment,
        lower_schedule,
    )
    from .executor import (
        BatchedProcessor,
        CompiledInference,
        PackRef,
        materialize,
        product_reduce,
        smart_stack,
        tree_stack,
        tree_unstack,
    )

__all__ = [
    "ComputeStep",
    "PhaseGroup",
    "StaticSchedule",
    "extract_schedule",
    "dep_role_key",
    "LoweredPlan",
    "ScanClass",
    "ScanSegment",
    "lower_schedule",
    "BatchedProcessor",
    "CompiledInference",
    "PackRef",
    "materialize",
    "smart_stack",
    "product_reduce",
    "tree_stack",
    "tree_unstack",
]
