"""Batched executor: run a :class:`StaticSchedule` as batched tensor calls.

The counterpart of ``cortex_tpu/compile/executor.py``.  The dynamic engine
dispatches one rule call per pending signal
(``src/inference_engine.jl:479-509``).  Here, all steps in a phase that share
a rule key execute as ONE batched call: dependency values are stacked along a
new leading *group* axis, the batched rule computes every signal in the group
at once, and results stay packed in the value table.

It runs eagerly: each phase is a few tensor operations on the device of the
inputs, a lowered scan segment is a Python loop over its iterations, and the
fixed-point loop is a plain loop.

Weak-dependency (VMP) semantics are preserved exactly: the value table starts
from the previous iteration's state, so a weak edge whose producer has not yet
run this sweep reads the stale value — the static equivalent of the
reference's weak-dependency pending criterion (``src/signal.jl:668-730``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import variants as V
from ..core.engine import InferenceEngine
from ..core.signal import Signal
from ..utils.tree import concatenate, stack, tree_leaves, tree_map, tree_structure
from .lowering import LoweredPlan, ScanSegment, lower_schedule
from .schedule import PhaseGroup, StaticSchedule, extract_schedule

__all__ = [
    "tree_stack",
    "tree_unstack",
    "PackRef",
    "materialize",
    "smart_stack",
    "BatchedProcessor",
    "product_reduce",
    "CompiledInference",
]


def tree_stack(values: Sequence[Any]) -> Any:
    """Stack a list of identically-structured trees along a new axis 0
    (:class:`ValueError` on a mismatch)."""
    return tree_map(lambda *xs: stack(xs, 0), *values)


def tree_unstack(stacked: Any, n: int) -> List[Any]:
    """Split axis 0 of a stacked tree back into n trees (views)."""
    return [tree_map(lambda a: a[i], stacked) for i in range(n)]


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _device(tree: Any):
    return next((x.device for x in tree_leaves(tree) if isinstance(x, torch.Tensor)), None)


class PackRef:
    """Lazy reference to row ``index`` of a stacked tree (``pack``).

    Group outputs stay *packed*: each value-table entry is a ``PackRef`` into
    its group's stacked output, and :func:`smart_stack` turns a dependency
    list that lives in one pack into a single gather (or the pack itself,
    when the rows align) — O(num_rule_groups) tensor operations per sweep
    instead of O(num_signals).
    """

    __slots__ = ("pack", "index", "length")

    def __init__(self, pack: Any, index: int, length: int) -> None:
        self.pack = pack
        self.index = index
        self.length = length

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PackRef(index={self.index}, length={self.length})"


def materialize(value: Any) -> Any:
    """Resolve a possibly-:class:`PackRef` table entry to a concrete tree."""
    if isinstance(value, PackRef):
        i = value.index
        return tree_map(lambda a: a[i], value.pack)
    return value


def smart_stack(values: Sequence[Any]) -> Any:
    """:func:`tree_stack` that recognizes rows of packs.

    If every element is a :class:`PackRef` into the SAME pack, return either
    the pack itself (rows ``0..n-1`` in order — zero-cost) or one gather.  If
    the elements span SEVERAL structurally-identical packs (e.g. a marginal
    family computed by two rule groups: chain interior + endpoints), one
    concatenate + one gather.  Otherwise materialize each element and stack.
    """
    first = values[0] if values else None
    if isinstance(first, PackRef) and all(isinstance(v, PackRef) for v in values):
        one_pack = all(v.pack is first.pack for v in values)
        if one_pack:
            idx = [v.index for v in values]
            if len(idx) == first.length and idx == list(range(first.length)):
                return first.pack
        # Maximal runs of consecutive rows (ascending or descending) within
        # one pack: when the whole request is a handful of runs, slices (views),
        # flips and one concatenate instead of a gather.  Deterministic group
        # ordering (schedule._variant_order_key) makes this the common case
        # for chain models.
        runs: List[List[Any]] = []  # [pack, start, stop, direction]
        for v in values:
            if runs and runs[-1][0] is v.pack:
                p, a, b, d = runs[-1]
                if d in (0, 1) and v.index == b + 1:
                    runs[-1][2], runs[-1][3] = v.index, 1
                    continue
                if d in (0, -1) and v.index == b - 1:
                    runs[-1][2], runs[-1][3] = v.index, -1
                    continue
            runs.append([v.pack, v.index, v.index, 0])
        try:
            if len(runs) <= max(2, len(values) // 8):
                parts = []
                for p, a, b, d in runs:
                    if d >= 0:
                        parts.append(tree_map(lambda x: x[a : b + 1], p))
                    else:
                        parts.append(tree_map(lambda x: torch.flip(x[b : a + 1], (0,)), p))
                if len(parts) == 1:
                    return parts[0]
                return tree_map(lambda *ls: concatenate(ls, 0), *parts)
            if one_pack:
                idx_arr = torch.tensor(
                    [v.index for v in values], device=_device(first.pack)
                )
                return tree_map(lambda a: a[idx_arr], first.pack)
            # Cross-pack scatter: one concatenate + one gather.
            packs: List[Any] = []
            offset: Dict[int, int] = {}
            total = 0
            for v in values:
                if id(v.pack) not in offset:
                    offset[id(v.pack)] = total
                    packs.append(v.pack)
                    total += v.length
            structs = {tree_structure(p) for p in packs}
            if len(structs) == 1:
                big = tree_map(lambda *ls: concatenate(ls, 0), *packs)
                idx_arr = torch.tensor(
                    [offset[id(v.pack)] + v.index for v in values], device=_device(big)
                )
                return tree_map(lambda a: a[idx_arr], big)
        except (ValueError, TypeError):
            pass  # heterogeneous row structures — slow path below
    return tree_stack([materialize(v) for v in values])


def product_reduce(dep_values: Sequence[Any]) -> Any:
    """Fold a list of same-family distribution batches with ``*`` — the
    batched analogue of the reference tests' ``reduce(product, deps)``
    (``test/inference_engine_tests.jl:392-412``).

    High-arity products (a mean-field noise posterior multiplies ~n
    messages) are not folded pairwise: when the family exposes
    ``reduce_product`` (every exponential family of
    :mod:`cortex_tpu_torch.dists`), the k operands are stacked along a new
    leading axis and reduced in ONE sum."""
    first = dep_values[0]
    if len(dep_values) > 2:
        reducer = getattr(type(first), "reduce_product", None)
        if reducer is not None and all(type(v) is type(first) for v in dep_values):
            try:
                return reducer(tree_stack(list(dep_values)), axis=0)
            except (ValueError, TypeError):
                pass  # heterogeneous shapes — pairwise fold below
    out = first
    for v in dep_values[1:]:
        out = out * v
    return out


class BatchedProcessor:
    """Batched rule set: the compiled counterpart of
    :class:`~cortex_tpu_torch.core.engine.InferenceRequestProcessor`.

    Each hook receives ``(engine, variants, dep_values)`` where ``variants``
    is the list of variant objects in the group (static metadata — all the
    same kind) and ``dep_values`` is a list over dependency positions of
    *stacked* trees (leading axis = group).  Hooks return a stacked tree of
    the group's new values.

    Product-flavored hooks default to information-form product reduction,
    which is what sum-product message passing needs; message hooks are
    model-specific.
    """

    def compute_message_to_variable(self, engine, variants, dep_values):
        raise NotImplementedError(
            f"compute_message_to_variable not implemented by {type(self).__name__}"
        )

    def compute_message_to_factor(self, engine, variants, dep_values):
        return product_reduce(dep_values)

    def compute_individual_marginal(self, engine, variants, dep_values):
        return product_reduce(dep_values)

    def compute_product_of_messages(self, engine, variants, dep_values):
        return product_reduce(dep_values)

    def compute_joint_marginal(self, engine, variants, dep_values):
        raise NotImplementedError(
            f"compute_joint_marginal not implemented by {type(self).__name__}"
        )

    def dispatch(self, engine, group: PhaseGroup, dep_values):
        kind = group.key[0]
        variants = [s.variant for s in group.steps]
        if kind == "MessageToVariable":
            return self.compute_message_to_variable(engine, variants, dep_values)
        if kind == "MessageToFactor":
            return self.compute_message_to_factor(engine, variants, dep_values)
        if kind == "IndividualMarginal":
            return self.compute_individual_marginal(engine, variants, dep_values)
        if kind == "ProductOfMessages":
            return self.compute_product_of_messages(engine, variants, dep_values)
        if kind == "JointMarginal":
            return self.compute_joint_marginal(engine, variants, dep_values)
        raise RuntimeError(f"Unprocessed signal variant kind: {kind}")


def _check_batch(out: Any, n: int, what: str, hint: str = "") -> None:
    for leaf in tree_leaves(out):
        if _shape(leaf)[:1] != (n,):
            raise ValueError(
                f"Rule for {what} returned a batch of leading shape "
                f"{_shape(leaf)[:1]}, expected ({n},){hint}."
            )


class CompiledInference:
    """A factor-graph inference request compiled to a static batched program.

    Parameters
    ----------
    engine:
        A resolver-wired :class:`InferenceEngine` (the graph "compile" step,
        reference ``src/inference_engine.jl:60-89``).
    variable_ids:
        Target variables whose marginals to compute (as in
        ``update_marginals!``).
    processor:
        A :class:`BatchedProcessor` with the model's batched rules.

    Call with ``inputs`` mapping each *source* signal (or its
    ``(variable_id, factor_id)`` message key) to a value.  For VMP graphs,
    iterate: ``state`` carries the previous sweep's marginals.  Every tensor
    operation runs on the device of the inputs and state.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        variable_ids: Sequence[int],
        processor: BatchedProcessor,
        refine_key=None,
        lower: bool = True,
    ) -> None:
        self.engine = engine
        self.processor = processor
        self.schedule: StaticSchedule = extract_schedule(
            engine, variable_ids, refine_key=refine_key
        )
        # Chain lowering: reroll unrolled linear recurrences into scan
        # segments (see cortex_tpu_torch.compile.lowering).  None when nothing
        # certifies — the phased execution below is then used directly.
        self.plan: Optional[LoweredPlan] = lower_schedule(self.schedule) if lower else None
        self._steady_state_cache = None
        self._full_plan: Optional[LoweredPlan] = None

    @property
    def full_plan(self) -> Optional[LoweredPlan]:
        """The lowered plan with EVERY sequence emitted as scan ys, so one
        plan sweep populates the full value table (the steady-state sweeps
        of ``fixed_point`` read every scheduled signal; the default plan
        elides scan-interior signals).  Built lazily; ``None`` when nothing
        lowers."""
        if self._full_plan is None and self.plan is not None:
            self._full_plan = lower_schedule(self.schedule, emit_all=True)
        return self._full_plan if self._full_plan is not None else self.plan

    # -- input plumbing ----------------------------------------------------
    def source_key(self, signal: Signal) -> Any:
        """Human-readable key for a source signal."""
        variant = signal.variant
        if isinstance(variant, V.MessageToFactor):
            return ("message_to_factor", variant.variable_id, variant.factor_id)
        if isinstance(variant, V.MessageToVariable):
            return ("message_to_variable", variant.variable_id, variant.factor_id)
        if isinstance(variant, V.IndividualMarginal):
            return ("marginal", variant.variable_id)
        return ("signal", id(signal))

    def source_keys(self) -> List[Any]:
        return [self.source_key(s) for s in self.schedule.sources]

    def initial_state(self) -> List[Any]:
        """Previous-iteration values for signals computed at compile time
        (e.g. VMP initial marginals), in stable order."""
        return [s.get_value() for s in self.schedule.initials]

    def _resolve_inputs(
        self, inputs: Mapping[Any, Any], source_pack: Any = None
    ) -> Dict[int, Any]:
        values: Dict[int, Any] = {}
        if source_pack is not None:
            # One stacked tree feeding ALL sources (row i = sources[i], the
            # order of schedule.sources / source_keys()).  Rows enter the
            # table as PackRefs, so a rule group whose dependencies are whole
            # source families costs one gather — not len(sources) slices.
            n = len(self.schedule.sources)
            for leaf in tree_leaves(source_pack):
                if _shape(leaf)[:1] != (n,):
                    raise ValueError(
                        f"source_pack leading axis must equal the number of "
                        f"sources ({n}), got {_shape(leaf)[:1]}."
                    )
            for i, s in enumerate(self.schedule.sources):
                values[id(s)] = PackRef(source_pack, i, n)
        by_key = {self.source_key(s): s for s in self.schedule.sources}
        for k, v in inputs.items():
            if k in by_key:
                sig = by_key[k]
            elif hasattr(k, "variant"):  # a Signal object
                sig = k
            else:
                raise KeyError(f"Unknown input key: {k!r}")
            values[id(sig)] = v
        missing = [self.source_key(s) for s in self.schedule.sources if id(s) not in values]
        if missing:
            raise ValueError(f"Missing inputs for sources: {missing[:5]}...")
        return values

    # -- execution ---------------------------------------------------------
    def _execute_phases(self, values: Dict[int, Any], phases) -> None:
        for phase in phases:
            for group in phase:
                n_deps = group.key[2]
                dep_values = []
                for j in range(n_deps):
                    try:
                        dep_values.append(
                            smart_stack([values[id(st.deps[j])] for st in group.steps])
                        )
                    except (ValueError, TypeError) as e:
                        raise TypeError(
                            f"Cannot batch dependency {j} of rule group "
                            f"{group.key}: the {len(group.steps)} steps carry "
                            "incompatible value structures/shapes. Split the "
                            "group with a refine_key (see "
                            "cortex_tpu_torch.compile.dep_role_key)."
                        ) from e
                out = self.processor.dispatch(self.engine, group, dep_values)
                n = len(group.steps)
                _check_batch(out, n, f"group {group.key}", " — one output per step in the group")
                # Lazy unstack: each signal's entry is a PackRef row into the
                # group output; downstream smart_stacks re-fuse them into one
                # gather (or reuse the pack outright).
                for i, st in enumerate(group.steps):
                    values[id(st.signal)] = PackRef(out, i, n)

    def _execute_plan(self, values: Dict[int, Any], plan: Optional[LoweredPlan] = None) -> None:
        """One dataflow sweep via the lowered plan (scan segments + batched
        phases); identical values to ``_execute_phases(schedule.phases)``."""
        plan = plan if plan is not None else self.plan
        if plan is None:
            self._execute_phases(values, self.schedule.phases)
            return
        for kind, seg in plan.segments:
            if kind == "phase":
                self._execute_phases(values, [seg])
            else:
                self._execute_scan(values, seg)

    def _execute_scan(self, values: Dict[int, Any], seg: ScanSegment) -> None:
        """Run one rerolled recurrence as a loop over its ``seg.length``
        iterations.

        Carry = the lookback windows of carried sequences; xs = stacked
        per-iteration external inputs; ys = outputs consumed outside the
        loop, collected per iteration and stacked once at the end."""
        xs_slot: Dict[Tuple[int, int, int], int] = {}
        xs_list: List[Any] = []
        for ci, cls in enumerate(seg.classes):
            for qi, specs in enumerate(cls.dep_specs):
                for d, spec in enumerate(specs):
                    if spec[0] == "xs":
                        xs_slot[(ci, qi, d)] = len(xs_list)
                        xs_list.append(smart_stack([values[id(s)] for s in spec[1]]))
        carry_slots = sorted(seg.carry_window)
        slot_index = {s: i for i, s in enumerate(carry_slots)}
        carry = tuple(
            tuple(materialize(values[id(sig)]) for sig in seg.carry_init[s])
            for s in carry_slots
        )
        emit = [
            (ci, qi)
            for ci, cls in enumerate(seg.classes)
            for qi, e in enumerate(cls.emit_ys)
            if e
        ]
        consts = {
            id(spec[1]): materialize(values[id(spec[1])])
            for cls in seg.classes
            for specs in cls.dep_specs
            for spec in specs
            if spec[0] == "const"
        }
        groups = [PhaseGroup(cls.key, [seq[0] for seq in cls.seqs]) for cls in seg.classes]
        ys: List[List[Any]] = [[] for _ in emit]

        for t in range(seg.length):
            xs_row = [tree_map(lambda a: a[t], x) for x in xs_list]
            outs: Dict[Tuple[int, int], Any] = {}
            for ci, cls in enumerate(seg.classes):
                n = len(cls.seqs)
                dep_values = []
                for d in range(len(cls.dep_specs[0])):
                    vals = []
                    for qi in range(n):
                        spec = cls.dep_specs[qi][d]
                        if spec[0] == "const":
                            vals.append(consts[id(spec[1])])
                        elif spec[0] == "xs":
                            vals.append(xs_row[xs_slot[(ci, qi, d)]])
                        elif spec[0] == "intra":
                            vals.append(outs[(spec[1], spec[2])])
                        else:  # carry
                            window = carry[slot_index[(spec[1], spec[2])]]
                            vals.append(window[spec[3] - 1])
                    try:
                        dep_values.append(tree_stack(vals))
                    except (ValueError, TypeError) as e:
                        raise TypeError(
                            f"Cannot batch dependency {d} of scan class "
                            f"{cls.key}: its {n} sequences carry incompatible "
                            "value structures/shapes. Construct "
                            "CompiledInference with lower=False or split the "
                            "group with a refine_key."
                        ) from e
                out = self.processor.dispatch(self.engine, groups[ci], dep_values)
                _check_batch(out, n, f"scan class {cls.key}")
                for qi, val in enumerate(tree_unstack(out, n)):
                    outs[(ci, qi)] = val
            carry = tuple((outs[s],) + carry[slot_index[s]][:-1] for s in carry_slots)
            for k, s in enumerate(emit):
                ys[k].append(outs[s])

        for (ci, qi), items in zip(emit, ys):
            arr = tree_stack(items)
            seq = seg.classes[ci].seqs[qi]
            for i, st in enumerate(seq):
                values[id(st.signal)] = PackRef(arr, i, len(seq))

    def steady_state_phases(self):
        """The steady-state sweep: ALL steps collapsed into one phase with
        one group per rule key, in first-appearance (dataflow) order.

        Semantics: block Gauss–Seidel over the rule groups — each group's
        outputs are visible to groups later in the phase within the same
        sweep; dependencies on same-or-later groups read the previous sweep's
        values.  Maximally batched (a chain model's O(n) dataflow phases
        become one rule call per group) at the price of more iterations to
        the same fixed point.  Only valid once every scheduled signal has a
        value (after one dataflow warm-start sweep).

        Caveat: steps that shared a rule key but sat in different dataflow
        phases are stacked together here; if their value structures differ
        (e.g. Gaussians of different dimension under one key), batching fails
        at the first steady-state sweep with an error naming the group —
        split such groups with ``refine_key``.
        """
        if self._steady_state_cache is None:
            groups: Dict[Any, PhaseGroup] = {}
            for phase in self.schedule.phases:
                for group in phase:
                    if group.key in groups:
                        groups[group.key].steps.extend(group.steps)
                    else:
                        groups[group.key] = PhaseGroup(group.key, list(group.steps))
            self._steady_state_cache = [list(groups.values())]
        return self._steady_state_cache

    def run(
        self,
        inputs: Mapping[Any, Any],
        state: Optional[Sequence[Any]] = None,
        *,
        source_pack: Any = None,
        packed: bool = False,
    ) -> Tuple[Dict[int, Any], List[Any]]:
        """Execute one full (dataflow-ordered) sweep.  Returns ``(marginals,
        new_state)`` where ``marginals`` maps variable_id → value and
        ``new_state`` carries the updated iteration state (for VMP fixed-point
        loops)."""
        return self.iterate(inputs, 1, state, source_pack=source_pack, packed=packed)

    def __call__(self, inputs: Mapping[Any, Any]) -> Dict[int, Any]:
        marginals, _ = self.run(inputs)
        return marginals

    def _start(self, inputs, state, source_pack) -> Dict[int, Any]:
        values: Dict[int, Any] = self._resolve_inputs(inputs, source_pack)
        if state is None:
            state = self.initial_state()
        for sig, val in zip(self.schedule.initials, state):
            values[id(sig)] = val
        return values

    def _results(self, values: Dict[int, Any], packed: bool):
        out = (lambda v: v) if packed else materialize
        marginals = {
            vid: out(values[id(sig)])
            for vid, sig in self.schedule.targets.items()
            if id(sig) in values
        }
        new_state = [out(values[id(s)]) for s in self.schedule.initials]
        return marginals, new_state

    def iterate(
        self,
        inputs: Mapping[Any, Any],
        n_iterations: int,
        state: Optional[Sequence[Any]] = None,
        steady_state: bool = False,
        *,
        source_pack: Any = None,
        packed: bool = False,
    ) -> Tuple[Dict[int, Any], List[Any]]:
        """Run ``n_iterations`` VMP sweeps, threading the iteration state.

        With ``steady_state=True`` the first sweep runs the dataflow-ordered
        schedule (warm start: every signal gets a value in a valid order) and
        subsequent sweeps run the maximally-batched block-Gauss-Seidel
        schedule (:meth:`steady_state_phases`) — the preferred mode for
        chain-heavy graphs whose dataflow schedule has many small phases.

        ``source_pack``: one stacked tree feeding all sources (row i =
        ``schedule.sources[i]``) — O(1) tensor operations instead of one per
        source.  ``packed=True`` returns marginal values as-is (possibly
        :class:`PackRef` rows); callers that consume whole marginal families
        should ``smart_stack([marginals[v] for v in family])`` — a single
        gather (or free) rather than per-variable slices.
        """
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        values = self._start(inputs, state, source_pack)
        for k in range(n_iterations):
            if steady_state and k > 0:
                self._execute_phases(values, self.steady_state_phases())
            else:
                self._execute_plan(values)
        return self._results(values, packed)

    def fixed_point(
        self,
        inputs: Mapping[Any, Any],
        n_iterations: int,
        state: Optional[Sequence[Any]] = None,
        mode: str = "steady_state",
        *,
        source_pack: Any = None,
        packed: bool = False,
    ) -> Tuple[Dict[int, Any], List[Any]]:
        """Run the VMP fixed-point loop: one dataflow warm-start sweep, then
        ``n_iterations - 1`` sweeps.

        The warm start runs the fully-emitting plan (:attr:`full_plan`), so
        every scheduled signal has a value before the loop.

        ``mode``: ``"steady_state"`` (default) iterates the maximally-batched
        block-Gauss-Seidel schedule; ``"dataflow"`` iterates the lowered
        dataflow plan — the right choice for chain-heavy graphs where the
        lowering produced scan segments (one sweep propagates information
        end-to-end instead of one hop).
        """
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        if mode not in ("steady_state", "dataflow"):
            raise ValueError(f"Unknown fixed_point mode: {mode!r}")
        values = self._start(inputs, state, source_pack)
        self._execute_plan(values, self.full_plan)
        for _ in range(n_iterations - 1):
            if mode == "dataflow":
                self._execute_plan(values, self.full_plan)
            else:
                self._execute_phases(values, self.steady_state_phases())
        return self._results(values, packed)

    def summary(self) -> str:
        out = self.schedule.summary()
        if self.plan is not None:
            out += "\n" + self.plan.summary()
        return out
