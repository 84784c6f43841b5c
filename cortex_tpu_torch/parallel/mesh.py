"""Process meshes over ``torch.distributed``, and sharding helpers.

The counterpart of ``cortex_tpu/parallel/mesh.py``.  JAX shards one global
array over a device mesh and lets ``shard_map`` hand each device its block.
The port is explicit SPMD instead: one process (rank) per block, each holding
its block as a plain tensor on its own device, running ordinary tensor code
on it and meeting the other ranks only in explicit collectives over the
process group of one mesh axis.  No DTensor: the kernels take plain tensors.

- ``replica`` axis: independent graph replicas (datasets / chains / particle
  sets), pure data parallelism, collectives only for reductions;
- ``time`` axis: time slices of long state-space chains
  (:mod:`cortex_tpu_torch.parallel.time_sharded`,
  :mod:`cortex_tpu_torch.parallel.pipelined`).

Backends.  A mesh on the card normally runs over NCCL, one rank per card.
A gloo group may also join ranks that compute on a card (several ranks
sharing one card, where NCCL refuses two ranks on one device).  gloo's
point-to-point operations take CPU tensors only, so every exchange of a gloo
group whose mesh lies on a card is staged through host memory: copied to the
host, exchanged, copied back.  That is decided by the group's backend, not
by catching an error, and the computation stays on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils import spans
from ..utils.tree import as_float32_tensor

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "all_gather",
    "all_reduce",
    "gather",
    "init_distributed",
    "make_mesh",
    "replica_sharding",
    "send_recv",
    "shard",
    "shard_replicas",
]


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: Optional[timedelta] = None,
) -> int:
    """Join (or make) the default process group and return the world size.

    Arguments not given are read from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` through
    ``env://``); a single process with neither gets a world of one.  The
    backend is NCCL for ``device="cuda"`` and gloo for the CPU unless
    ``backend`` names another.  On the card the process's current device
    becomes ``cuda:<local_rank>`` (ranks that share one card pass
    ``local_rank=0``).  Does nothing when a group is already initialized.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    on_card = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if on_card:
        torch.cuda.set_device(local_rank)
    kwargs = {} if timeout is None else {"timeout": timeout}
    if init_method is None and "MASTER_ADDR" not in env:
        if world_size != 1:
            raise ValueError(
                "init_distributed needs init_method (or torchrun's environment) "
                f"for a world of {world_size}")
        kwargs["store"] = dist.HashStore()
    elif init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return world_size


# Every mesh's exchanges in this process: calls, and bytes sent by this rank.
_COLLECTIVE = spans.counter_group("collective", ("calls", "bytes"))


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks with named axes, as this rank sees it.

    ``ranks`` holds the global ranks laid out in the grid; ``coords`` is this
    rank's index along each axis; ``groups`` its process group along each
    axis (the ranks that differ from it only in that axis's index).  Blocks
    live on ``device``.
    """

    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.ranks.shape))

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def axis_rank(self, axis: str, index: int) -> int:
        """Global rank of the rank at ``index`` along ``axis`` that shares this
        rank's other coordinates."""
        where = [self.coords[name] for name in self.axis_names]
        where[self.axis_names.index(axis)] = index
        return int(self.ranks[tuple(where)])

    def staged(self, axis: str) -> bool:
        """Whether exchanges along ``axis`` go through host memory: a gloo
        group whose blocks lie on a card."""
        return self.device.type == "cuda" and dist.get_backend(self.groups[axis]) == "gloo"


def make_mesh(
    axis_sizes: Optional[Sequence[Tuple[str, int]]] = None,
    device="cuda",
) -> Optional[Mesh]:
    """Lay the world's ranks out in a grid and make one process group per
    axis line.  Every rank of the world must call it, with the same arguments.

    ``axis_sizes`` is an ordered list of ``(axis_name, size)``; by default a
    1-D ``("replica", world_size)`` mesh.  One axis may be ``-1`` to absorb
    the remaining ranks.  The mesh takes ranks ``0 .. size-1``; a rank beyond
    it gets ``None``.  Blocks live on ``device`` (the card unless the caller
    asks for the CPU): ``"cuda"`` means the process's current card.  An NCCL
    world needs the card.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [("replica", world)]
    names = [name for name, _ in axis_sizes]
    sizes = [size for _, size in axis_sizes]
    if sizes.count(-1) > 1:
        raise ValueError("At most one axis may have size -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if world % known:
            raise ValueError(
                f"Cannot infer -1 axis: {world} ranks not divisible by {known}"
            )
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total > world:
        raise ValueError(f"Mesh needs {total} ranks, only {world} present")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda" and dist.get_backend() == "nccl":
        raise ValueError("an NCCL world keeps its blocks on the card, not on the CPU")
    ranks = np.arange(total).reshape(sizes)
    rank = dist.get_rank()
    groups = {}
    for k, name in enumerate(names):
        lines = np.moveaxis(ranks, k, -1).reshape(-1, sizes[k]).tolist()
        groups[name], _ = dist.new_subgroups_by_enumeration(lines)
    if rank >= total:
        return None
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    return Mesh(tuple(names), ranks, coords, groups, device)


class P(tuple):
    """Partition spec: per leading dimension, the mesh axis it is split over
    or ``None`` (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes: Optional[str]):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: P


def replica_sharding(mesh: Mesh, axis: str = "replica") -> NamedSharding:
    """Sharding that splits the leading (replica) dimension over ``axis``."""
    return NamedSharding(mesh, P(axis))


def _split_dims(x_shape, sharding: NamedSharding):
    """``(dim, axis)`` of each split dimension; raises on a spec the shape or
    the mesh cannot take."""
    spec, mesh = sharding.spec, sharding.mesh
    if len(spec) > len(x_shape):
        raise ValueError(f"spec {spec} has more entries than the {len(x_shape)} dimensions")
    used = [axis for axis in spec if axis is not None]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} splits over one mesh axis twice")
    for axis in used:
        if axis not in mesh.coords:
            raise ValueError(f"spec {spec} names {axis!r}, not an axis of {mesh.axis_names}")
    return [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]


def shard(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole ``x`` (a tensor or an array), on the
    mesh's device (``jax.device_put``).  A dimension must divide evenly over
    its axis.  The block may share memory with ``x``.  An array that is not a
    tensor becomes float32 (integers: int32), as ``jax.device_put`` makes it;
    a tensor keeps its dtype."""
    x = as_float32_tensor(x)
    mesh = sharding.mesh
    for dim, axis in _split_dims(x.shape, sharding):
        n, size = mesh.shape[axis], x.shape[dim]
        if size % n:
            raise ValueError(
                f"dimension {dim} of size {size} must divide evenly over the {n} ranks "
                f"of mesh axis {axis!r}")
        step = size // n
        x = x.narrow(dim, mesh.coords[axis] * step, step)
    return x.to(mesh.device).contiguous()


def shard_replicas(x, mesh: Mesh, axis: str = "replica") -> torch.Tensor:
    """This rank's block of ``x`` with its leading axis split over ``axis``."""
    return shard(x, replica_sharding(mesh, axis))


def gather(block: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole tensor from every rank's block (the inverse of
    :func:`shard`): one ``all_gather`` per split dimension, on every rank."""
    for dim, axis in _split_dims(block.shape, sharding):
        parts = all_gather(block, sharding.mesh, axis)
        block = torch.cat(list(parts.unbind(0)), dim=dim)
    return block


class _Exchange:
    """Counts one exchange into the ``collective`` counters, inside the span
    ``name`` (``collective.<operation>``); on a staged axis, moves tensors to
    the host and back, inside the span too."""

    def __init__(self, mesh: Mesh, axis: str, nbytes: int, name: str):
        self.mesh, self.staged, self.nbytes = mesh, mesh.staged(axis), nbytes
        self.span = spans.span(name)

    def out(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.cpu() if self.staged else tensor

    def back(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(self.mesh.device) if self.staged else tensor

    def __enter__(self):
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        _COLLECTIVE["calls"] += 1
        _COLLECTIVE["bytes"] += self.nbytes
        self.span.__exit__(*exc)
        return False


def all_gather(tensor: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``tensor`` along ``axis``, stacked in axis order: shape
    ``(mesh.shape[axis], *tensor.shape)`` (``lax.all_gather``)."""
    with _Exchange(mesh, axis, tensor.numel() * tensor.element_size(),
                   "collective.all_gather") as ex:
        mine = ex.out(tensor.contiguous())
        parts = [torch.empty_like(mine) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, mine, group=mesh.groups[axis])
        return ex.back(torch.stack(parts))


def all_reduce(tensor: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``tensor`` along ``axis`` (``lax.psum``)."""
    with _Exchange(mesh, axis, tensor.numel() * tensor.element_size(),
                   "collective.all_reduce") as ex:
        total = ex.out(tensor).clone()
        dist.all_reduce(total, group=mesh.groups[axis])
        return ex.back(total)


def send_recv(
    tensor: torch.Tensor,
    mesh: Mesh,
    axis: str,
    send_to: Optional[int],
    recv_from: Optional[int],
) -> Optional[torch.Tensor]:
    """One step of a permutation along ``axis`` (``lax.ppermute``): send
    ``tensor`` to the rank at index ``send_to`` and receive a tensor of its
    shape from the rank at ``recv_from`` (either may be ``None``), both in one
    ``batch_isend_irecv``.  Returns the received tensor, or ``None``.  Every
    rank of the permutation must call it in the same step."""
    if send_to is None and recv_from is None:
        return None
    group = mesh.groups[axis]
    sending = send_to is not None
    with _Exchange(mesh, axis, tensor.numel() * tensor.element_size() * sending,
                   "collective.send_recv") as ex:
        ops: List[dist.P2POp] = []
        if sending:
            ops.append(dist.P2POp(dist.isend, ex.out(tensor.contiguous()),
                                  mesh.axis_rank(axis, send_to), group))
        received = None
        if recv_from is not None:
            received = torch.empty(tensor.shape, dtype=tensor.dtype,
                                   device="cpu" if ex.staged else tensor.device)
            ops.append(dist.P2POp(dist.irecv, received, mesh.axis_rank(axis, recv_from), group))
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return None if received is None else ex.back(received)
