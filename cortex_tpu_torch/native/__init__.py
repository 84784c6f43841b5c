"""Native (C++) runtime components.

The dynamic reactive path gets a C++ core for the hot state machine
(:class:`NativeSignalEngine` — bit-packed dependency flags, O(listeners)
notification with precomputed slots, SWAR pending checks), compiled on demand
with the system toolchain into the package's build directory and bound via
ctypes.  Values and rule dispatch stay in Python; graph state transitions run
native.  ``signal_core.cpp`` is the JAX package's source.
"""

from .bindings import NativeSignal, NativeSignalEngine, load_native_lib

__all__ = ["NativeSignalEngine", "NativeSignal", "load_native_lib"]
