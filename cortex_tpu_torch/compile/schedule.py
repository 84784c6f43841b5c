"""Static schedule extraction: signal DAG → topologically-phased compute plan.

The reference discovers its schedule dynamically — pending bits propagate and
``process_dependencies!`` walks them per sweep (``src/inference_engine.jl:
512-525``; its own ``scan_inference_request`` at ``:540-546`` proves the
schedule can be extracted as data).  On the device the graph is fixed after resolver
wiring (``src/inference_engine.jl:84-86``), so we extract the *whole* schedule
once:

1. collect the signals needed for the requested targets (backward reachability
   through dependency edges),
2. classify sources (signals with no dependencies, or already computed at
   compile time — observations, initial VMP marginals),
3. assign phases by longest-path layering over strong edges.  Weak edges
   (VMP) do not constrain ordering — they read the previous iteration's value,
   exactly the reference's weak-dependency semantics
   (``src/signal.jl:668-730``) made static,
4. group each phase's steps by *rule key* ``(variant kind, factor functional
   form, arity)`` — each group executes as ONE batched rule call.

The resulting :class:`StaticSchedule` is pure data; execution lives in
:mod:`cortex_tpu_torch.compile.executor`.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import variants as V
from ..core.engine import InferenceEngine
from ..core.signal import Signal

__all__ = ["ComputeStep", "PhaseGroup", "StaticSchedule", "extract_schedule"]


@dataclasses.dataclass
class ComputeStep:
    """One signal computation: the static analogue of a traced execution."""

    signal: Signal
    variant: Any
    deps: List[Signal]
    weak_mask: Tuple[bool, ...]


@dataclasses.dataclass
class PhaseGroup:
    """All steps in one phase sharing a rule key — one batched rule call."""

    key: Tuple[str, Optional[Any], int]
    steps: List[ComputeStep]


@dataclasses.dataclass
class StaticSchedule:
    """Phased compute plan over the signal DAG."""

    phases: List[List[PhaseGroup]]
    sources: List[Signal]  # required inputs (uncomputed, no deps)
    initials: List[Signal]  # computed at compile time (VMP initial marginals)
    targets: Dict[int, Signal]  # variable_id -> marginal signal
    linked: Dict[int, List[Signal]]  # variable_id -> linked signals
    # unscheduled candidates: never-computable OR frozen computed (stale reads)
    skipped: List[Signal]

    @property
    def num_steps(self) -> int:
        return sum(len(g.steps) for phase in self.phases for g in phase)

    def summary(self) -> str:
        lines = [
            f"StaticSchedule: {len(self.phases)} phases, {self.num_steps} steps, "
            f"{len(self.sources)} sources, {len(self.initials)} initials, "
            f"{len(self.skipped)} skipped"
        ]
        for i, phase in enumerate(self.phases):
            parts = ", ".join(f"{g.key[0]}/{g.key[1]}×{len(g.steps)}" for g in phase)
            lines.append(f"  phase {i}: {parts}")
        return "\n".join(lines)


def _variant_order_key(signal: Signal):
    """Deterministic within-group/source ordering: (kind rank, variable id,
    factor id).  Chain models built in time order thus get packs whose rows
    follow the chain — downstream `smart_stack` consumption lowers to
    slices/reverses instead of gathers (views: no copy of device memory),
    and `source_pack` rows follow model order instead of traversal order."""
    v = signal.variant
    if isinstance(v, (V.MessageToFactor, V.MessageToVariable)):
        return (0, v.variable_id, v.factor_id)
    if isinstance(v, V.IndividualMarginal):
        return (1, v.variable_id, -1)
    if isinstance(v, V.ProductOfMessages):
        return (2, v.variable_id, tuple(v.range))
    if isinstance(v, V.JointMarginal):
        return (3, v.factor_id, tuple(v.variable_ids))
    return (4, 0, 0)


def _rule_key(engine: InferenceEngine, signal: Signal) -> Tuple[str, Optional[Any], int]:
    variant = signal.variant
    kind = type(variant).__name__
    form: Optional[Any] = None
    if isinstance(variant, (V.MessageToVariable, V.MessageToFactor)):
        form = engine.get_factor(variant.factor_id).functional_form
    elif isinstance(variant, V.JointMarginal):
        form = engine.get_factor(variant.factor_id).functional_form
    return (kind, form, len(signal.get_dependencies()))


def _signal_role(engine: InferenceEngine, signal: Signal) -> str:
    variant = signal.variant
    if isinstance(
        variant,
        (V.IndividualMarginal, V.MessageToFactor, V.MessageToVariable, V.ProductOfMessages),
    ):
        return engine.get_variable(variant.variable_id).name
    return type(variant).__name__


def dep_role_key(engine: InferenceEngine, signal: Signal):
    """A ready-made key refinement: ``(own role, dependency roles)`` where a
    role is the associated variable's name (marginals, messages, products) or
    the variant kind otherwise.

    Use as ``extract_schedule(..., refine_key=dep_role_key)`` when the default
    ``(variant, factor form, arity)`` key hides semantically different rules —
    e.g. mean-field VMP where the message to ``x`` depends on ``(q(y),
    q(noise))`` while the message to ``noise`` depends on ``(q(y), q(x))``
    (cf. the reference's name-dispatching test processor,
    ``test/inference_engine_tests.jl:653-696``)."""
    roles = tuple(
        _signal_role(engine, dep) for dep in signal.get_dependencies()
    )
    return (_signal_role(engine, signal), roles)


def extract_schedule(
    engine: InferenceEngine,
    variable_ids: Sequence[int],
    *,
    treat_computed_as_sources: bool = True,
    refine_key=None,
) -> StaticSchedule:
    """Extract the static schedule for updating the marginals of
    ``variable_ids`` (the compile-time analogue of ``update_marginals!``).

    Signals already computed at compile time (e.g. VMP initial marginals set
    with ``set_value``) become *initials*: their current slot is an input to
    the first iteration, and they are ALSO scheduled for recomputation when
    they have dependencies (the VMP fixed-point update).

    ``refine_key``: optional ``(engine, signal) -> hashable`` appended to the
    default rule key, splitting groups whose default key hides semantically
    different rules (see :func:`dep_role_key`).
    """
    if isinstance(variable_ids, int):
        variable_ids = (variable_ids,)

    targets: Dict[int, Signal] = {}
    linked: Dict[int, List[Signal]] = {}
    roots: List[Signal] = []
    for vid in variable_ids:
        variable = engine.get_variable(vid)
        targets[vid] = variable.marginal
        linked[vid] = list(variable.linked_signals)
        roots.append(variable.marginal)
        roots.extend(variable.linked_signals)

    # -- visitability: mirror process_dependencies' traversal ---------------
    # The dynamic engine applies its callback to every direct dependency of a
    # walked signal but recurses only through *intermediate*-flagged edges
    # (reference ``src/signal.jl:466-490``).  Only visitable signals can ever
    # be computed by this request; everything else is a read.
    visitable: Dict[int, Signal] = {}
    recursed: set = set()

    def visit(s: Signal) -> None:
        if id(s) in recursed:
            return
        recursed.add(id(s))
        deps = s.get_dependencies()
        for i, dep in enumerate(deps):
            visitable.setdefault(id(dep), dep)
            if s.dep_is_intermediate(i):
                visit(dep)

    for root in roots:
        visitable.setdefault(id(root), root)
        visit(root)

    # -- computability fixpoint --------------------------------------------
    # A visitable signal with dependencies is computable iff every dependency
    # is available: a user-provided source, a compile-time-computed value, or
    # itself computable.  (Matches the dynamic engine: a signal whose inputs
    # can never all become computed never pends and is silently skipped.)
    candidates = [s for s in visitable.values() if s.get_dependencies()]
    candidate_ids = {id(s) for s in candidates}
    known: Dict[int, Signal] = dict(visitable)
    for s in visitable.values():
        for dep in s.get_dependencies():
            known.setdefault(id(dep), dep)
    # Non-candidates: computed → frozen reads; uncomputed & depless → inputs.
    fixed_computed_ids = {
        i
        for i, s in known.items()
        if i not in candidate_ids and s.is_computed()
    }
    source_ids = {
        i
        for i, s in known.items()
        if i not in candidate_ids
        and not s.is_computed()
        and not s.get_dependencies()
    }

    by_id = {id(s): s for s in candidates}

    def _availability_fixpoint(active: set) -> set:
        """Worklist fixpoint, O(edges): drop signals with an unavailable
        dependency and cascade removals through consumers of *uncomputed*
        dependencies (a removed-but-compile-time-computed dependency remains
        available as a frozen read)."""
        computable_set = set(active)
        consumers: Dict[int, List[int]] = defaultdict(list)
        stack: List[int] = []
        for sid in active:
            s = by_id[sid]
            for dep in s.get_dependencies():
                did = id(dep)
                if did in computable_set:
                    if not dep.is_computed():
                        consumers[did].append(sid)
                elif not (
                    did in source_ids
                    or did in fixed_computed_ids
                    or dep.is_computed()
                ):
                    stack.append(sid)
        while stack:
            sid = stack.pop()
            if sid not in computable_set:
                continue
            computable_set.discard(sid)
            stack.extend(consumers[sid])
        return computable_set

    def _ordering_deps(s: Signal, computable_set: set, strong_only: bool):
        """Edges that constrain in-sweep ordering: strong edges to scheduled
        signals always; weak edges additionally when the producer is
        scheduled but UNCOMPUTED at compile time (first sweep must produce
        before the read — the static analogue of the dynamic warm-up where a
        weak dependency cannot satisfy the pending criterion until first
        computed, reference ``src/signal.jl:668-730``)."""
        out = []
        for i, d in enumerate(s.get_dependencies()):
            if id(d) not in computable_set:
                continue
            if not s.dep_is_weak(i):
                out.append(d)
            elif not strong_only and not d.is_computed():
                out.append(d)
        return out

    def _kahn(computable_set: set, strong_only: bool):
        indeg: Dict[int, int] = {}
        dependents: Dict[int, List[Signal]] = defaultdict(list)
        phase: Dict[int, int] = {}
        for sid in computable_set:
            s = by_id[sid]
            od = _ordering_deps(s, computable_set, strong_only)
            indeg[sid] = len(od)
            for d in od:
                dependents[id(d)].append(s)
        frontier = [by_id[sid] for sid in computable_set if indeg[sid] == 0]
        for s in frontier:
            phase[id(s)] = 0
        while frontier:
            s = frontier.pop()
            for t in dependents[id(s)]:
                indeg[id(t)] -= 1
                phase[id(t)] = max(phase.get(id(t), 0), phase[id(s)] + 1)
                if indeg[id(t)] == 0:
                    frontier.append(t)
        leftover = {sid for sid in computable_set if indeg[sid] > 0}
        return phase, leftover

    # Iterate: availability fixpoint → ordering; weak-deadlocked cycles
    # (mutually-uncomputed weak reads) are dropped — the dynamic engine never
    # computes them either — and the drop may cascade through consumers.
    active = set(candidate_ids)
    while True:
        computable_set = _availability_fixpoint(active)
        phase_of, leftover = _kahn(computable_set, strong_only=False)
        if not leftover:
            break
        _, strong_leftover = _kahn(leftover, strong_only=True)
        if strong_leftover:
            # Trim signals merely downstream of a cycle: iteratively peel
            # nodes with no strong dependents inside the set, leaving the
            # actual cycle members for the error message.
            core = set(strong_leftover)
            peeled = True
            while peeled:
                peeled = False
                has_dependent: set = set()
                for sid in core:
                    for d in _ordering_deps(by_id[sid], core, strong_only=True):
                        has_dependent.add(id(d))
                for sid in list(core):
                    if sid not in has_dependent:
                        core.discard(sid)
                        peeled = True
            cyclic = [by_id[sid] for sid in (core or strong_leftover)]
            raise ValueError(
                "Strong-dependency cycle detected among "
                f"{len(cyclic)} signals; cyclic structures must use weak "
                "dependencies (VMP) to be compilable. Example variant: "
                f"{cyclic[0].variant!r}"
            )
        active = computable_set - leftover

    # Everything visitable-but-unscheduled: never-computable signals AND
    # compile-time-computed candidates whose updates are frozen (their values
    # are read as stale state forever).  Recorded for observability — a VMP
    # marginal landing here means its update silently never runs.
    skipped = [s for s in candidates if id(s) not in computable_set]
    computable = [s for s in candidates if id(s) in computable_set]

    # A requested target landing in `skipped` means the update the user asked
    # for silently never runs — e.g. a VMP marginal in a weak-deadlocked
    # cycle.  Warn by default (engine warning + Python warning), mirroring
    # the reference's soft-diagnostic style (``src/inference_engine.jl:11-14``;
    # dangling case ``src/dependencies.jl:40-43``).
    #
    # Only the target's OWN marginal/linked signals being skipped warrants
    # the warning.  A target merely *reading* a skipped-but-computed signal
    # (e.g. an observed variable's frozen marginal in mean-field VMP) is
    # correct and matches dynamic semantics — the dynamic engine never
    # recomputes such signals either (their pending criterion can't satisfy,
    # ``src/signal.jl:668-730``); flagging those was a false positive on
    # canonical VMP models.  The availability fixpoint guarantees a
    # *computable* target can only reach a skipped signal through such a
    # frozen read, so membership is the exact criterion.
    if skipped:
        skipped_ids = {id(s) for s in skipped}
        affected = [
            vid
            for vid, sig in targets.items()
            if id(sig) in skipped_ids
            or any(id(ls) in skipped_ids for ls in linked[vid])
        ]
        if affected:
            description = (
                f"{len(affected)} requested target(s) depend on "
                f"{len(skipped)} unschedulable signal(s) (never-computable "
                "or frozen at their compile-time value); their updates will "
                "silently never run. Example skipped variant: "
                f"{skipped[0].variant!r}"
            )
            engine.add_warning(description, affected)
            warnings.warn(description, stacklevel=2)

    # Iteration state ("initials"): every compile-time-computed signal that
    # participates — frozen reads (observed marginals, excluded candidates)
    # and computed computables (VMP marginals, re-computed each sweep but
    # read stale through weak edges on the first one).
    initials: List[Signal] = []
    seen_init: set = set()
    for i, s in known.items():
        if s.is_computed() and treat_computed_as_sources and id(s) not in seen_init:
            seen_init.add(id(s))
            initials.append(s)
    initials.sort(key=_variant_order_key)
    sources = sorted(
        (known[i] for i in source_ids), key=_variant_order_key
    )

    # -- bucket into phases and rule-key groups ----------------------------
    nphases = 1 + max((phase_of[id(s)] for s in computable), default=-1)
    phase_groups: List[Dict[Any, List[ComputeStep]]] = [
        defaultdict(list) for _ in range(nphases)
    ]
    for s in sorted(computable, key=_variant_order_key):
        deps = s.get_dependencies()
        weak_mask = tuple(s.dep_is_weak(i) for i in range(len(deps)))
        key = _rule_key(engine, s)
        if refine_key is not None:
            key = key + (refine_key(engine, s),)
        phase_groups[phase_of[id(s)]][key].append(
            ComputeStep(s, s.variant, list(deps), weak_mask)
        )
    phases: List[List[PhaseGroup]] = [
        [PhaseGroup(k, steps) for k, steps in groups.items()]
        for groups in phase_groups
    ]

    return StaticSchedule(phases, sources, initials, targets, linked, skipped)
