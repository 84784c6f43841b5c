"""Reactive signal core — the L1 substrate of the framework.

A :class:`Signal` is a node in a (possibly cyclic) dependency graph that holds a
value, a ``variant`` tag, a bit-packed per-dependency state word, and listener
lists.  Signals implement the *lazy pending* protocol: value updates only flip
cheap "potentially pending" bits on listeners; the actual pending determination
is deferred to the next :meth:`Signal.is_pending` read and cached.

Semantics mirror the reference implementation (Cortex.jl's ``src/signal.jl``):

- per-dependency flags packed 4 bits per dependency into 64-bit chunks
  (IsIntermediate ``0x1``, IsWeak ``0x2``, IsComputed ``0x4``, IsFresh ``0x8``;
  reference ``src/signal.jl:36-45,507-526``),
- the pending criterion: a signal may become pending iff it has at least one
  dependency and for **every** dependency ``IsComputed AND (IsWeak OR IsFresh)``
  (reference ``src/signal.jl:668-730``),
- ``set_value`` clears all own deps' fresh bits, resets own props, and notifies
  listeners; the notification marks the *first* identity-matching dependency
  slot computed+fresh (duplicate dependencies are a documented hazard;
  reference ``src/signal.jl:232-253,339-356``),
- ``add_dependency`` supports ``weak`` / ``listen`` / ``intermediate`` /
  ``check_computed`` flags with the reference's exact state transitions
  (reference ``src/signal.jl:286-337``),
- ``process_dependencies`` is the traversal/scheduling primitive with recursion
  into intermediate dependencies and optional retry
  (reference ``src/signal.jl:429-490``).

This dynamic engine is the debugging/parity path.  The batched execution path
(:mod:`cortex_tpu_torch.compile`) compiles the dependency DAG that resolvers build on
top of these signals into a static, type-batched program of tensor operations.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

__all__ = [
    "UndefValue",
    "UndefVariant",
    "UNDEF",
    "UNDEF_VARIANT",
    "Signal",
    "compute_value",
]


class UndefValue:
    """Singleton representing "no value yet" (reference ``src/signal.jl:7``)."""

    _instance: Optional["UndefValue"] = None

    def __new__(cls) -> "UndefValue":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "UndefValue()"


class UndefVariant:
    """Singleton representing "no variant" (reference ``src/signal.jl:15``)."""

    _instance: Optional["UndefVariant"] = None

    def __new__(cls) -> "UndefVariant":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "UndefVariant()"


UNDEF = UndefValue()
UNDEF_VARIANT = UndefVariant()

# Bit masks within a 4-bit nibble (reference src/signal.jl:507-510).
_INTERMEDIATE = 0x1
_WEAK = 0x2
_COMPUTED = 0x4
_FRESH = 0x8

# All-nibble masks within a 64-bit chunk (reference src/signal.jl:512-519).
_INTERMEDIATE_ALL = 0x1111_1111_1111_1111
_WEAK_ALL = 0x2222_2222_2222_2222
_COMPUTED_ALL = 0x4444_4444_4444_4444
_FRESH_ALL = 0x8888_8888_8888_8888
_PASS_TARGET = 0x1111_1111_1111_1111
_U64 = 0xFFFF_FFFF_FFFF_FFFF


class _DependenciesProps:
    """Bit-packed per-dependency flags: 4 bits per dependency, 16 per chunk.

    Mirrors ``SignalDependenciesProps`` (reference ``src/signal.jl:36-45,
    507-655``).  Kept as a standalone object so the C++ native core can share
    the exact chunk layout.
    """

    __slots__ = ("length", "chunks")

    def __init__(self) -> None:
        self.length = 0
        self.chunks: List[int] = [0]

    def add_dependency(self) -> int:
        """Append a zeroed nibble; return the (0-based) slot index."""
        index = self.length
        self.length += 1
        required_chunks = (4 * self.length + 63) // 64
        if len(self.chunks) < required_chunks:
            self.chunks.append(0)
        return index

    @staticmethod
    def _offset(index: int) -> tuple:
        return index >> 4, (index & 15) << 2

    def _is(self, index: int, mask: int) -> bool:
        ci, off = self._offset(index)
        return (self.chunks[ci] & (mask << off)) != 0

    def _set(self, index: int, mask: int) -> None:
        ci, off = self._offset(index)
        self.chunks[ci] |= mask << off

    def _unset(self, index: int, mask: int) -> None:
        ci, off = self._offset(index)
        self.chunks[ci] &= _U64 ^ (mask << off)

    # Per-slot accessors -------------------------------------------------
    def is_intermediate(self, i: int) -> bool:
        return self._is(i, _INTERMEDIATE)

    def is_weak(self, i: int) -> bool:
        return self._is(i, _WEAK)

    def is_computed(self, i: int) -> bool:
        return self._is(i, _COMPUTED)

    def is_fresh(self, i: int) -> bool:
        return self._is(i, _FRESH)

    def set_intermediate(self, i: int) -> None:
        self._set(i, _INTERMEDIATE)

    def set_weak(self, i: int) -> None:
        self._set(i, _WEAK)

    def set_computed(self, i: int) -> None:
        self._set(i, _COMPUTED)

    def set_fresh(self, i: int) -> None:
        self._set(i, _FRESH)

    def unset_intermediate(self, i: int) -> None:
        self._unset(i, _INTERMEDIATE)

    def unset_weak(self, i: int) -> None:
        self._unset(i, _WEAK)

    def unset_computed(self, i: int) -> None:
        self._unset(i, _COMPUTED)

    def unset_fresh(self, i: int) -> None:
        self._unset(i, _FRESH)

    # Whole-array operations --------------------------------------------
    def unset_all_fresh(self) -> None:
        chunks = self.chunks
        for i in range(len(chunks)):
            chunks[i] &= _U64 ^ _FRESH_ALL

    def set_all_fresh(self) -> None:
        chunks = self.chunks
        for i in range(len(chunks)):
            chunks[i] |= _FRESH_ALL

    def meets_pending_criteria(self) -> bool:
        """Branch-free SWAR check of ``all(C & (W | F))`` over the nibbles.

        Mirrors ``is_meeting_pending_criteria`` (reference
        ``src/signal.jl:668-730``): zero dependencies never pend; the partial
        last chunk has its unused nibbles padded so they pass.
        """
        n = self.length
        if n == 0:
            return False
        chunks = self.chunks
        nchunks = len(chunks)
        for i in range(nchunks - 1):
            chunk = chunks[i]
            w = (chunk & _WEAK_ALL) >> 1
            c = (chunk & _COMPUTED_ALL) >> 2
            f = (chunk & _FRESH_ALL) >> 3
            if (c & (w | f)) != _PASS_TARGET:
                return False
        ci, off = self._offset(n - 1)
        pad = (_U64 << (off + 4)) & _U64
        chunk = chunks[ci] | pad
        w = (chunk & _WEAK_ALL) >> 1
        c = (chunk & _COMPUTED_ALL) >> 2
        f = (chunk & _FRESH_ALL) >> 3
        return (c & (w | f)) == _PASS_TARGET

    def flags_repr(self) -> str:
        parts = []
        for i in range(self.length):
            parts.append(
                "("
                + ("w," if self.is_weak(i) else "!w,")
                + ("i," if self.is_intermediate(i) else "!i,")
                + ("c," if self.is_computed(i) else "!c,")
                + ("f" if self.is_fresh(i) else "!f")
                + ")"
            )
        return "".join(parts)


class Signal:
    """A reactive node in a dependency graph (reference ``src/signal.jl:82-115``).

    Parameters
    ----------
    value:
        Initial value; defaults to :data:`UNDEF` meaning "not computed yet".
    variant:
        Arbitrary tag used for rule dispatch; defaults to :data:`UNDEF_VARIANT`.
    """

    __slots__ = (
        "value",
        "variant",
        "_is_potentially_pending",
        "_is_pending",
        "_deps_props",
        "_dependencies",
        "_listenmask",
        "_listeners",
    )

    def __init__(self, value: Any = UNDEF, variant: Any = UNDEF_VARIANT) -> None:
        self.value = value
        self.variant = variant
        self._is_potentially_pending = False
        self._is_pending = False
        self._deps_props = _DependenciesProps()
        self._dependencies: List["Signal"] = []
        self._listenmask: List[bool] = []
        self._listeners: List["Signal"] = []

    # -- basic accessors (reference src/signal.jl:124-219) ---------------
    @staticmethod
    def value_type() -> type:
        """Parity shim for the reference's ``value_type`` (``src/signal.jl:124``):
        Python signals are untyped, i.e. the ``D = Any`` case."""
        return object

    @staticmethod
    def variant_type() -> type:
        """Parity shim for ``variant_type`` (``src/signal.jl:133``)."""
        return object

    def is_computed(self) -> bool:
        return self.value is not UNDEF

    def get_value(self) -> Any:
        return self.value

    def get_variant(self) -> Any:
        return self.variant

    def set_variant(self, variant: Any) -> None:
        self.variant = variant

    def isa_variant(self, t: type) -> bool:
        return isinstance(self.variant, t)

    def get_dependencies(self) -> List["Signal"]:
        return self._dependencies

    def get_listeners(self) -> List["Signal"]:
        return self._listeners

    def is_pending(self) -> bool:
        """Lazy pending resolution (reference ``src/signal.jl:141-154``)."""
        if self._is_pending:
            return True
        if self._is_potentially_pending:
            new_pending = self._deps_props.meets_pending_criteria()
            self._is_potentially_pending = False
            self._is_pending = new_pending
            return new_pending
        return False

    def dep_is_weak(self, i: int) -> bool:
        return self._deps_props.is_weak(i)

    def dep_is_intermediate(self, i: int) -> bool:
        return self._deps_props.is_intermediate(i)

    def dep_is_fresh(self, i: int) -> bool:
        return self._deps_props.is_fresh(i)

    def new_sibling(self) -> "Signal":
        """Create a fresh inference signal compatible with this one (same
        arena/backend).  Resolvers use it for intermediate signals so native
        and Python graphs stay homogeneous."""
        from .variants import create_inference_signal

        return create_inference_signal()

    def mark_potentially_pending(self) -> None:
        """Flag this signal for lazy pending re-evaluation (used by inference
        requests; reference ``src/inference_engine.jl:305-318``)."""
        self._is_potentially_pending = True
        self._is_pending = False

    # -- mutation ---------------------------------------------------------
    def set_value(self, value: Any) -> None:
        """Write ``value`` and notify active listeners.

        Marks all own dependencies "not fresh" (their values have now been
        consumed) and resets the pending state
        (reference ``src/signal.jl:232-253``).
        """
        self.value = value
        self._deps_props.unset_all_fresh()
        self._is_potentially_pending = False
        self._is_pending = False
        listeners = self._listeners
        listenmask = self._listenmask
        for i in range(len(listeners)):
            listeners[i]._notify_from(self, update_potentially_pending=listenmask[i])

    def _notify_from(self, signal: "Signal", update_potentially_pending: bool) -> None:
        """Reference ``notify_listener!`` (``src/signal.jl:339-356``)."""
        if update_potentially_pending:
            self._is_potentially_pending = True
            self._is_pending = False
        deps = self._dependencies
        props = self._deps_props
        for i in range(len(deps)):
            if deps[i] is signal:
                props.set_fresh(i)
                props.set_computed(i)
                break

    def add_dependency(
        self,
        dependency: "Signal",
        *,
        weak: bool = False,
        listen: bool = True,
        check_computed: bool = True,
        intermediate: bool = False,
    ) -> None:
        """Add a dependency edge (reference ``src/signal.jl:286-337``).

        ``weak`` dependencies only need to be *computed* (not fresh) for this
        signal to pend.  With ``listen=False`` the dependency is recorded but
        its future updates do not notify this signal.  With ``check_computed``
        an already-computed dependency immediately notifies this signal
        (fresh only if this signal is not yet computed); a not-yet-computed
        dependency clears any pending state.  Self-dependency is a no-op.
        Duplicate dependencies are a documented hazard: only the first
        occurrence ever receives notifications.
        """
        if dependency is self:
            return
        props = self._deps_props
        index = props.add_dependency()
        if weak:
            props.set_weak(index)
        if intermediate:
            props.set_intermediate(index)
        self._dependencies.append(dependency)
        dependency._listenmask.append(bool(listen))
        dependency._listeners.append(self)
        if check_computed and dependency.is_computed():
            props.set_computed(index)
            if not self.is_computed():
                props.set_fresh(index)
            self._is_potentially_pending = True
            self._is_pending = False
        elif check_computed and not dependency.is_computed():
            self._is_potentially_pending = False
            self._is_pending = False

    def add_dependencies(
        self,
        dependencies,
        *,
        weak: bool = False,
        listen: bool = True,
        check_computed: bool = True,
        intermediate: bool = False,
    ) -> None:
        """Add several dependencies with shared flags (bulk counterpart of
        :meth:`add_dependency`; one FFI call on the native backend)."""
        for dependency in dependencies:
            self.add_dependency(
                dependency,
                weak=weak,
                listen=listen,
                check_computed=check_computed,
                intermediate=intermediate,
            )

    # -- compute interface (reference src/signal.jl:372-424) --------------
    def compute(
        self,
        strategy: Any,
        *,
        force: bool = False,
        skip_if_no_listeners: bool = False,
    ) -> None:
        """Recompute this signal's value from its dependencies via ``strategy``.

        ``strategy`` is either a callable ``(signal, dependencies) -> value``
        or an object implementing ``compute_value(signal, dependencies)``.
        Raises ``ValueError`` when called on a non-pending signal unless
        ``force=True`` (reference ``src/signal.jl:392-410``).
        """
        if skip_if_no_listeners and not self._listeners:
            return
        if not force and not self.is_pending():
            raise ValueError(
                "Signal is not pending. Cannot compute a non-pending signal. "
                f"Use force=True to force computation. Signal: {self!r}, "
                f"dependencies: {self._dependencies!r}"
            )
        new_value = compute_value(strategy, self, self._dependencies)
        self.set_value(new_value)

    # -- traversal primitive (reference src/signal.jl:429-490) ------------
    def process_dependencies(
        self, f: Callable[["Signal"], bool], *, retry: bool = False
    ) -> bool:
        """Apply ``f`` to each direct dependency; recurse into intermediates.

        For each dependency: call ``f(dep)``; if it returns ``False`` and the
        dependency is flagged *intermediate*, recurse into it, and — when
        ``retry`` and the recursion processed at least one sub-dependency —
        re-apply ``f`` to the intermediate itself.  Returns whether ``f``
        returned ``True`` at least once anywhere.
        """
        deps = self._dependencies
        props = self._deps_props
        processed_at_least_once = False
        for i in range(len(deps)):
            dependency = deps[i]
            processed = f(dependency)
            if not processed and props.is_intermediate(i):
                sub_processed = dependency.process_dependencies(f, retry=retry)
                if sub_processed and retry:
                    processed = f(dependency)
                processed_at_least_once = processed_at_least_once or sub_processed
            processed_at_least_once = processed_at_least_once or processed
        return processed_at_least_once

    # -- misc --------------------------------------------------------------
    def __repr__(self) -> str:
        val_str = repr(self.value) if self.is_computed() else "#undef"
        out = f"Signal(value={val_str}, pending={str(self.is_pending()).lower()}"
        if self.variant is not UNDEF_VARIANT:
            out += f", variant={self.variant!r}"
        return out + ")"


def compute_value(strategy: Any, signal: Signal, dependencies: List[Signal]) -> Any:
    """Dispatch a computation strategy (reference ``src/signal.jl:412-424``)."""
    if callable(strategy) and not hasattr(strategy, "compute_value"):
        return strategy(signal, dependencies)
    if hasattr(strategy, "compute_value"):
        return strategy.compute_value(signal, dependencies)
    raise TypeError(
        f"compute_value must be implemented for the given strategy of type "
        f"{type(strategy).__name__}"
    )
