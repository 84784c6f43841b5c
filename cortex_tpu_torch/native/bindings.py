"""ctypes bindings + build-on-demand for the C++ signal core.

:class:`NativeSignal` exposes the same API as the pure-Python
:class:`~cortex_tpu_torch.core.signal.Signal` (duck-typed), so the dynamic
:class:`~cortex_tpu_torch.core.engine.InferenceEngine` runs unchanged on native
state: pass native signals into ``Variable(marginal=...)`` /
``Connection(message_to_*=...)`` or use the engine's convenience constructors.

The library is built with ``g++`` at first use into the kernels' build
directory (:data:`cortex_tpu_torch._build.BUILD_DIR`, git-ignored; see
:func:`cortex_tpu_torch._build.set_build_dir`), named by a hash of the source
and the flags.  Each process compiles to a file of its own and moves it into
place, so processes that build at once never read a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, List


from .. import _build
from ..core.signal import UNDEF, UNDEF_VARIANT, compute_value
from ..core import variants as V
from ..core.model_engine import Connection, Variable

__all__ = ["load_native_lib", "NativeSignalEngine", "NativeSignal"]

SOURCE = Path(__file__).resolve().parent / "signal_core.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library built from this source and these flags lies."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return _build.BUILD_DIR / f"libsignal_core_{digest.hexdigest()[:16]}.so"


def load_native_lib() -> ctypes.CDLL:
    """Compile (if needed) and load the native signal core.  Once loaded, the
    library stays for the life of the process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            try:
                built = subprocess.run(cmd, capture_output=True, text=True)
                if built.returncode != 0:
                    raise RuntimeError(f"g++ failed building {so.name}:\n{built.stderr}")
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(so))

        lib.ce_new.restype = ctypes.c_void_p
        lib.ce_free.argtypes = [ctypes.c_void_p]
        lib.ce_signal_new.argtypes = [ctypes.c_void_p]
        lib.ce_signal_new.restype = ctypes.c_int32
        lib.ce_num_signals.argtypes = [ctypes.c_void_p]
        lib.ce_num_signals.restype = ctypes.c_int32
        lib.ce_add_dependency.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ce_set_value.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        for name in ("ce_is_computed", "ce_is_pending"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            fn.restype = ctypes.c_int
        lib.ce_set_potentially_pending.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ce_num_dependencies.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ce_num_dependencies.restype = ctypes.c_int32
        lib.ce_get_dependency.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.ce_get_dependency.restype = ctypes.c_int32
        lib.ce_num_listeners.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ce_num_listeners.restype = ctypes.c_int32
        lib.ce_get_listener.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.ce_get_listener.restype = ctypes.c_int32
        for name in (
            "ce_is_dep_intermediate",
            "ce_is_dep_weak",
            "ce_is_dep_fresh",
            "ce_is_dep_computed",
        ):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
            fn.restype = ctypes.c_int
        lib.ce_add_dependencies_bulk.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ce_scan_pending.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.ce_scan_pending.restype = ctypes.c_int32

        _LIB = lib
        return _LIB


class NativeSignalEngine:
    """Owner of a native signal arena.  Create signals with
    :meth:`create_signal` / :meth:`create_inference_signal`; model-structure
    helpers (:meth:`variable`, :meth:`connection`) build Variables/Connections
    backed by native signals."""

    def __init__(self) -> None:
        self._lib = load_native_lib()
        self._handle = ctypes.c_void_p(self._lib.ce_new())
        self._signals: List["NativeSignal"] = []

    def __del__(self) -> None:  # pragma: no cover - finalizer
        try:
            if self._handle:
                self._lib.ce_free(self._handle)
                self._handle = None
        except Exception:
            pass

    def create_signal(self, value: Any = UNDEF, variant: Any = UNDEF_VARIANT):
        sid = self._lib.ce_signal_new(self._handle)
        sig = NativeSignal(self, sid, value, variant)
        self._signals.append(sig)
        if value is not UNDEF:
            self._lib.ce_set_value(self._handle, sid)
        return sig

    def create_inference_signal(self) -> "NativeSignal":
        return self.create_signal(UNDEF, V.Unspecified())

    def variable(self, name: str, index: Any = None) -> Variable:
        return Variable(name, index, marginal=self.create_inference_signal())

    def connection(self, label: str, index: int = 0) -> Connection:
        return Connection(
            label,
            index,
            message_to_variable=self.create_inference_signal(),
            message_to_factor=self.create_inference_signal(),
        )

    def signal(self, sid: int) -> "NativeSignal":
        return self._signals[sid]

    def scan_pending(self, root: "NativeSignal") -> List["NativeSignal"]:
        """Native fast path for schedule scanning (collect pending signals in
        traversal order without computing them)."""
        cap = self._lib.ce_num_signals(self._handle)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.ce_scan_pending(self._handle, root._sid, buf, cap)
        return [self._signals[buf[i]] for i in range(min(n, cap))]


class NativeSignal:
    """A signal whose state machine lives in the C++ engine.

    Same API surface as :class:`~cortex_tpu.core.signal.Signal`; value and
    variant stay Python-side.
    """

    __slots__ = ("_engine", "_sid", "value", "variant")

    def __init__(self, engine: NativeSignalEngine, sid: int, value, variant):
        self._engine = engine
        self._sid = sid
        self.value = value
        self.variant = variant

    # -- accessors ---------------------------------------------------------
    def is_computed(self) -> bool:
        return bool(
            self._engine._lib.ce_is_computed(self._engine._handle, self._sid)
        )

    def is_pending(self) -> bool:
        return bool(
            self._engine._lib.ce_is_pending(self._engine._handle, self._sid)
        )

    def get_value(self) -> Any:
        return self.value

    def get_variant(self) -> Any:
        return self.variant

    def set_variant(self, variant: Any) -> None:
        self.variant = variant

    def isa_variant(self, t: type) -> bool:
        return isinstance(self.variant, t)

    def get_dependencies(self) -> List["NativeSignal"]:
        lib, h = self._engine._lib, self._engine._handle
        n = lib.ce_num_dependencies(h, self._sid)
        return [
            self._engine._signals[lib.ce_get_dependency(h, self._sid, i)]
            for i in range(n)
        ]

    def get_listeners(self) -> List["NativeSignal"]:
        lib, h = self._engine._lib, self._engine._handle
        n = lib.ce_num_listeners(h, self._sid)
        return [
            self._engine._signals[lib.ce_get_listener(h, self._sid, i)]
            for i in range(n)
        ]

    # -- mutation ----------------------------------------------------------
    def set_value(self, value: Any) -> None:
        self.value = value
        self._engine._lib.ce_set_value(self._engine._handle, self._sid)

    def dep_is_weak(self, i: int) -> bool:
        return bool(
            self._engine._lib.ce_is_dep_weak(self._engine._handle, self._sid, i)
        )

    def dep_is_intermediate(self, i: int) -> bool:
        return bool(
            self._engine._lib.ce_is_dep_intermediate(
                self._engine._handle, self._sid, i
            )
        )

    def dep_is_fresh(self, i: int) -> bool:
        return bool(
            self._engine._lib.ce_is_dep_fresh(self._engine._handle, self._sid, i)
        )

    def new_sibling(self) -> "NativeSignal":
        """Fresh inference signal in the same native arena (see
        ``Signal.new_sibling``)."""
        return self._engine.create_inference_signal()

    def mark_potentially_pending(self) -> None:
        self._engine._lib.ce_set_potentially_pending(
            self._engine._handle, self._sid
        )

    def add_dependency(
        self,
        dependency: "NativeSignal",
        *,
        weak: bool = False,
        listen: bool = True,
        check_computed: bool = True,
        intermediate: bool = False,
    ) -> None:
        self._engine._lib.ce_add_dependency(
            self._engine._handle,
            self._sid,
            dependency._sid,
            int(weak),
            int(listen),
            int(check_computed),
            int(intermediate),
        )

    def add_dependencies(
        self,
        dependencies,
        *,
        weak: bool = False,
        listen: bool = True,
        check_computed: bool = True,
        intermediate: bool = False,
    ) -> None:
        """Bulk edge insertion (shared flags): one FFI call for the whole
        list — the fast path for large graph construction."""
        n = len(dependencies)
        if n == 0:
            return
        buf = (ctypes.c_int32 * n)(*[d._sid for d in dependencies])
        self._engine._lib.ce_add_dependencies_bulk(
            self._engine._handle,
            self._sid,
            buf,
            n,
            int(weak),
            int(listen),
            int(check_computed),
            int(intermediate),
        )

    # -- compute / traversal ----------------------------------------------
    def compute(
        self,
        strategy: Any,
        *,
        force: bool = False,
        skip_if_no_listeners: bool = False,
    ) -> None:
        if skip_if_no_listeners and not self.get_listeners():
            return
        if not force and not self.is_pending():
            raise ValueError(
                "Signal is not pending. Cannot compute a non-pending signal. "
                "Use force=True to force computation."
            )
        new_value = compute_value(strategy, self, self.get_dependencies())
        self.set_value(new_value)

    def process_dependencies(
        self, f: Callable[["NativeSignal"], bool], *, retry: bool = False
    ) -> bool:
        lib, h = self._engine._lib, self._engine._handle
        deps = self.get_dependencies()
        processed_at_least_once = False
        for i, dependency in enumerate(deps):
            processed = f(dependency)
            if not processed and lib.ce_is_dep_intermediate(h, self._sid, i):
                sub = dependency.process_dependencies(f, retry=retry)
                if sub and retry:
                    processed = f(dependency)
                processed_at_least_once = processed_at_least_once or sub
            processed_at_least_once = processed_at_least_once or processed
        return processed_at_least_once

    def __repr__(self) -> str:
        val_str = repr(self.value) if self.is_computed() else "#undef"
        out = f"NativeSignal(value={val_str}, pending={str(self.is_pending()).lower()}"
        if self.variant is not UNDEF_VARIANT:
            out += f", variant={self.variant!r}"
        return out + ")"
