"""Serving layer: ahead-of-time export, CUDA graphs, portable programs, bucketed batching.

The counterpart of the JAX package's ``serve.py``, on PyTorch's tools:

- **Ahead-of-time compilation** (:func:`aot_compile`): ``torch.export``
  traces ``fn`` once at the example shapes into a graph of ATen operators and
  the package's kernels (each kernel one node: see
  :mod:`~cortex_tpu_torch.ops.kernels`).  On the card the exported program is
  warmed up and captured into one ``torch.cuda.CUDAGraph``, so a request
  replays every launch of the call without Python.  The wrapper exposes a
  static cost model (operations, bytes) counted from the graph, for capacity
  planning.
- **Portable serialized programs** (:func:`export_serialized` /
  :func:`load_serialized`): ``torch.export.save`` payloads that load where
  this package's ``ops`` is imported (it registers the kernels' operators),
  without the Python model code.
- **Shape-bucketed serving** (:class:`BucketedServer`): ragged request
  batches are padded up to a small set of power-of-two buckets, so a handful
  of static shapes (one graph each) serve every batch size.

Plus :func:`enable_persistent_cache`, which keeps the built kernel libraries
in one directory across process restarts.

A captured graph reads fixed input buffers and writes fixed output buffers,
so a call checks its arguments against the example (a wrongly shaped request
raises ``TypeError`` instead of being broadcast into the buffer) and returns
copies of the outputs (the next request does not overwrite the last answer).
"""

from __future__ import annotations

import io
import math
import operator
import os
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .ops import kernels
from .utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten, treedef_str

__all__ = [
    "aot_compile",
    "export_serialized",
    "load_serialized",
    "enable_persistent_cache",
    "BucketedServer",
]

# Calls on a side stream before capture: the first builds and loads the
# kernels and fills their caches (a copy to the card may not run while a
# stream captures), as torch's own rule for CUDA graphs asks.
WARMUP_CALLS = 3


class MemoryAnalysis(NamedTuple):
    """A compiled program's footprint in bytes, with XLA's names."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int  # every intermediate result, none freed early
    graph_pool_bytes: Optional[int]  # the CUDA graph's memory pool; None on the CPU


class _Bound(torch.nn.Module):
    """``fn`` with the arguments at ``static_argnums`` bound to their example
    values; called with the others, in order."""

    def __init__(self, fn: Callable, args: Sequence[Any], static_argnums: Sequence[int]):
        super().__init__()
        self.fn = fn
        self.n_args = len(args)
        self.static = {i: args[i] for i in static_argnums}

    def forward(self, *dynamic):
        it = iter(dynamic)
        return self.fn(*(self.static[i] if i in self.static else next(it)
                         for i in range(self.n_args)))


def _export(fn: Callable, args: Sequence[Any], static_argnums: Sequence[int] = ()):
    """``(exported program, dynamic arguments)`` of ``fn`` at ``args``."""
    static = {i % len(args) for i in static_argnums}
    dynamic = tuple(a for i, a in enumerate(args) if i not in static)
    for leaf in tree_leaves(dynamic):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"a dynamic argument's leaf must be a tensor, got {type(leaf).__name__}: "
                "pass it in static_argnums")
    return torch.export.export(_Bound(fn, args, sorted(static)), dynamic), dynamic


def _nbytes(value: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(value)
               if isinstance(t, torch.Tensor))


def _values(node_args: Any) -> Any:
    return torch.fx.node.map_arg(node_args, lambda n: n.meta.get("val"))


def _node_cost(node) -> Tuple[float, float]:
    """``(operations, bytes)`` of one node of an exported graph, from its
    shapes alone."""
    from torch.utils.flop_counter import flop_registry

    target = node.target
    args, kwargs = _values(node.args), _values(node.kwargs)
    out = node.meta.get("val")
    if getattr(target, "namespace", None) == kernels.NAMESPACE:
        return kernels.COSTS[target.__name__.split(".")[0]](*args, **kwargs)
    if getattr(target, "is_view", False):
        return 0.0, 0.0
    nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
    packet = getattr(target, "overloadpacket", None)
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out)), nbytes
    if torch.Tag.pointwise in getattr(target, "tags", ()):
        return float(sum(t.numel() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))), nbytes
    return 0.0, nbytes


class CompiledFn:
    """An exported program at fixed shapes, captured into a CUDA graph when
    its example lies on the card, with a static cost model.

    Call it with the dynamic arguments only (those not in ``static_argnums``),
    of the example's structure, shapes, dtypes and devices: anything else
    raises ``TypeError``.  On the card a call copies the arguments into the
    graph's input buffers, replays the graph and returns copies of its
    outputs; on the CPU it runs the exported program.
    """

    def __init__(self, exported, example: Tuple[Any, ...]):
        self._exported = exported
        self._module = exported.module()
        leaves, self._in_def = tree_flatten(example)
        self._specs = [(tuple(t.shape), t.dtype, t.device) for t in leaves]
        self._graph = None
        # Launches of each kernel in the captured graph: one replay runs each
        # of them once.  Empty on the CPU.
        self.captured_launches: Dict[str, int] = {}
        if any(t.device.type == "cuda" for t in leaves):
            self._capture(leaves)

    def _capture(self, leaves) -> None:
        device = next(t.device for t in leaves if t.device.type == "cuda")
        self._inputs = [t.clone() for t in leaves]
        args = tree_unflatten(self._in_def, self._inputs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self._module(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph):
            self._outputs = self._module(*args)
        self.captured_launches = {name: kernels.LAUNCHES[name] - count
                                  for name, count in before.items()}
        self._graph = graph

    def _check(self, args) -> list:
        leaves, in_def = tree_flatten(args)
        if in_def != self._in_def:
            raise TypeError(
                "Argument structure differs from the one this function was compiled for: "
                f"{treedef_str(in_def)}, compiled for {treedef_str(self._in_def)}")
        for i, (leaf, (shape, dtype, device)) in enumerate(zip(leaves, self._specs)):
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"argument leaf {i} is a {type(leaf).__name__}, not a tensor")
            if (tuple(leaf.shape), leaf.dtype, leaf.device) != (shape, dtype, device):
                raise TypeError(
                    f"Argument types differ from the types for which this function was "
                    f"compiled: leaf {i} is {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}, "
                    f"compiled for {dtype} {shape} on {device}")
        return leaves

    def __call__(self, *args):
        leaves = self._check(args)
        if self._graph is None:
            return self._module(*args)
        for buffer, leaf in zip(self._inputs, leaves):
            buffer.copy_(leaf)
        self._graph.replay()
        return tree_map(torch.clone, self._outputs)

    def cost_analysis(self) -> dict:
        """The static cost model, with nothing run: ``"flops"`` (one an
        element for elementwise operators, ``torch.utils.flop_counter``'s
        formulas for products, the kernels' own counts) and ``"bytes
        accessed"`` (each operator's operands and results; views none; the
        kernels' own counts), summed over the graph."""
        flops = nbytes = 0.0
        for node in self._exported.graph.nodes:
            if node.op == "call_function" and node.target is not operator.getitem:
                f, b = _node_cost(node)
                flops += f
                nbytes += b
        return {"flops": flops, "bytes accessed": nbytes}

    def _pool_bytes(self) -> Optional[int]:
        """Bytes of the device memory segments of the captured graph's pool."""
        if self._graph is None:
            return None
        pool = tuple(self._graph.pool())
        return sum(segment["total_size"] for segment in torch.cuda.memory_snapshot()
                   if tuple(segment["segment_pool_id"]) == pool)

    def memory_analysis(self) -> MemoryAnalysis:
        """Argument, output and intermediate bytes from the graph's shapes,
        and on the card the bytes the captured graph's memory pool holds."""
        nodes = self._exported.graph.nodes
        outputs = set(next(n for n in nodes if n.op == "output").all_input_nodes)
        temp = sum(_nbytes(n.meta.get("val")) for n in nodes
                   if n.op == "call_function" and n.target is not operator.getitem
                   and not getattr(n.target, "is_view", False) and n not in outputs)
        arguments = sum(math.prod(shape) * dtype.itemsize for shape, dtype, _ in self._specs)
        output = sum(_nbytes(n.meta.get("val")) for n in outputs)
        return MemoryAnalysis(arguments, output, temp, self._pool_bytes())

    def as_text(self) -> str:
        """The exported program's text: its signature and graph."""
        return str(self._exported)


def aot_compile(fn: Callable, *example_args, static_argnums=()) -> CompiledFn:
    """Export ``fn`` for the shapes/dtypes of ``example_args`` ahead of time
    (the arguments at ``static_argnums`` bound to their example values) and,
    on the card, capture it into a CUDA graph.  The returned callable never
    retraces: calls must match the example structure (that is the point)."""
    exported, dynamic = _export(fn, example_args, static_argnums)
    return CompiledFn(exported, dynamic)


def export_serialized(fn: Callable, *example_args) -> bytes:
    """Serialize ``fn`` (exported at the example shapes) to a portable
    ``torch.export`` payload.  Load it with :func:`load_serialized` — in any
    process that imports ``cortex_tpu_torch.ops``, without the defining
    Python code.  Named-tuple outputs need their class registered with
    torch's tree utilities; a plain tuple needs nothing."""
    exported, _ = _export(fn, example_args)
    exported.example_inputs = None  # the payload carries the program, not the example's data
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    return buffer.getvalue()


def load_serialized(blob: bytes) -> Callable:
    """Rehydrate a payload from :func:`export_serialized` into a callable
    (the exported program's module)."""
    return torch.export.load(io.BytesIO(blob)).module()


def enable_persistent_cache(path: str) -> None:
    """Build the kernel library and the native signal core into ``path``, and
    look for them there, so restarts (and sibling processes) load what an
    earlier process built instead of compiling.  Creates ``path``; safe to
    call more than once.  A library this process has already loaded stays
    loaded from where it was: the directory counts for the libraries this
    process has not loaded yet, and for every later process that calls this."""
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class BucketedServer:
    """Pad ragged request batches onto a fixed ladder of compiled shapes.

    ``fn(batch, ...)`` must be batched over a leading axis of every tensor
    argument.  Requests of any size up to ``max_batch`` are padded with zeros
    up to the nearest power-of-two bucket (so at most ``log2(max_batch)+1``
    distinct programs, and on the card graphs, exist), executed, and sliced
    back; named tuples and dataclasses among the outputs keep their class.
    With ``precompile=True`` every bucket is compiled up front from the
    example arguments — no compile latency at serve time.
    """

    def __init__(
        self,
        fn: Callable,
        example_args: Tuple[Any, ...],
        max_batch: int = 1024,
        min_bucket: int = 8,
        precompile: bool = False,
    ):
        self._fn = fn
        self.buckets = [
            1 << k
            for k in range(
                int(math.log2(min_bucket)), int(math.ceil(math.log2(max_batch))) + 1
            )
        ]
        self._compiled: dict[int, CompiledFn] = {}
        self._example = example_args
        if precompile:
            for b in self.buckets:
                self._get(b)

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._compiled))

    def compiled(self, b: int) -> CompiledFn:
        """The compiled function of bucket ``b`` (compiled now if it is not)."""
        return self._get(b)

    def _pad(self, args, b: int):
        def pad_leaf(a):
            a = torch.as_tensor(a)
            if a.shape[0] >= b:  # example larger than the bucket: slice down
                return a[:b]
            return torch.cat([a, a.new_zeros((b - a.shape[0], *a.shape[1:]))])

        return tree_map(pad_leaf, args)

    def _get(self, b: int) -> CompiledFn:
        if b not in self._compiled:
            self._compiled[b] = aot_compile(self._fn, *self._pad(self._example, b))
        return self._compiled[b]

    def __call__(self, *args):
        n = tree_leaves(args)[0].shape[0]
        b = _bucket_for(n, self.buckets)
        out = self._get(b)(*self._pad(args, b))
        return tree_map(lambda o: o[:n], out)
