"""The system under test for the time-sharded LGSSM smoother:
``parallel.lgssm_smooth_time_sharded(block, A, Q, H, R, mesh=mesh)`` in each
of the configuration's ``ranks`` processes, one card each, each on its
contiguous block of ``T / ranks`` steps of one ``(R, T)`` batch a call; the
blocks' filter and smoother elements are exchanged by the port's
``all_gather`` over the mesh's ``time`` axis.

Every rank runs what a user's SPMD job runs: ``parallel.init_distributed``
(NCCL on the card, gloo on the CPU), ``parallel.make_mesh([("time", n)])``,
its block cut by ``parallel.shard``, and the smoother.  The harness's
process is rank 0, on its current card; :func:`build` starts ranks 1..n-1 as
Python processes of this file, on cards 1..n-1, with torchrun's environment;
every rank's collectives time out after ``COLLECTIVE_TIMEOUT``.

- ``pack(ring)`` broadcasts each whole batch once, at set-up, and every rank
  keeps its block of it.  Rank 0 keeps the whole ring too: the judge needs
  whole inputs.
- Each call, rank 0 broadcasts one small command over a gloo group of its
  own (the batch, the call's sequence number, and the sequence numbers of
  the outputs rank 0 no longer holds), under the host span
  ``bench.command``: the benchmark's plumbing, which puts no work on the
  card.  Then it runs its block.  Ranks 1..n-1 keep their blocks' outputs
  for exactly the calls whose output rank 0 still holds (a
  ``weakref.finalize`` on each of rank 0's outputs announces its release in
  the next command).
- Rank 0's output is complete only after its two exchanges, so every rank
  has reached its last one; the next command orders the next call after the
  rest of each rank's work.
- ``results(out)`` gathers the call's blocks into the whole ``(R, T)`` mean
  and variance with the port's ``parallel.gather``, after the window.
  ``inputs`` and ``results`` hand their ``(R, T)`` tensors over laid out
  time-major (transposed views, as ``lgssm_graph``'s), the order in which
  the configuration's reference reads them; the transpose is the card's.
- Ranks 1..n-1 exit when rank 0 stops them (when the entry is freed, or at
  exit) or when rank 0 is gone (their standard input closes); rank 0 then
  leaves the world alone.  When one of them is lost, rank 0 stops the
  others and exits at once, with status 1.

A call is ``R (3T - 2)`` message updates over the whole chain; its least time
(``cost``) is one rank's share, ``costs.lgssm_call(R, T / n)``: the ranks run
side by side.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from datetime import timedelta
from pathlib import Path

if __name__ == "__main__":  # a worker rank: the checkout's root holds perfbench
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch
import torch.distributed as dist

from perfbench import costs

# The command: [op, batch, seq, releases, released seq...].
PACK, CALL, GATHER, STOP = 1, 2, 3, 4
MAX_RELEASES = 60
COMMAND = 4 + MAX_RELEASES
# A collective that waits longer for a rank than this fails the run.
COLLECTIVE_TIMEOUT = timedelta(seconds=300)
# Ranks 1..n-1 wait for each command through rank 0's judge: a timeout of
# its own, far over the collective timeout.  A lost rank 0 closes their
# standard input, which ends them at once.
COMMAND_TIMEOUT = timedelta(hours=2)
STOP_WAIT_S = 60.0
WATCH_S = 0.2


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(config: dict, traffic: dict, device: str):
    """The mesh of this rank, its sharding of a batch and the command group;
    every rank calls it once it belongs to the world."""
    from cortex_tpu_torch import parallel

    mesh = parallel.make_mesh([("time", int(config["ranks"]))], device=device)
    sharding = parallel.NamedSharding(mesh, parallel.P(None, "time"))
    commands = dist.new_group(backend="gloo", timeout=COMMAND_TIMEOUT)
    return mesh, sharding, commands


class _World:
    """Rank 0's side of the world: the worker processes, the command group
    and the outputs released since the last command.  Holds nothing of the
    entry, so that the entry can be freed."""

    def __init__(self, workers, commands):
        self.workers = workers
        self.commands = commands
        self.released: list = []
        self.stopping = False
        self.cmd = torch.zeros(COMMAND, dtype=torch.int64)
        threading.Thread(target=self._watch, daemon=True).start()

    def command(self, op: int, batch: int = 0, seq: int = 0) -> None:
        rel = self.released[:MAX_RELEASES]
        del self.released[:len(rel)]
        cmd = self.cmd
        cmd.zero_()
        cmd[:4] = torch.tensor([op, batch, seq, len(rel)])
        if rel:
            cmd[4:4 + len(rel)] = torch.tensor(rel)
        with torch.profiler.record_function("bench.command"):
            dist.broadcast(cmd, src=0, group=self.commands)

    def _watch(self) -> None:
        """Exit at once, stopping the rest, when a worker is lost."""
        while not self.stopping:
            for r, w in enumerate(self.workers, 1):
                if w.poll() is not None and not self.stopping:
                    print(f"lgssm_timeshard: rank {r} exited with {w.returncode}; "
                          "stopping the world", file=sys.stderr, flush=True)
                    for other in self.workers:
                        if other.poll() is None:
                            other.kill()
                    os._exit(1)
            time.sleep(WATCH_S)

    def stop(self) -> None:
        """Stop the workers, wait for them to exit, and leave the world."""
        if self.stopping:
            return
        self.stopping = True
        try:
            self.command(STOP)
        except Exception as err:  # a world already broken: the workers are killed below
            print(f"lgssm_timeshard: stop: {err}", file=sys.stderr, flush=True)
        deadline = time.monotonic() + STOP_WAIT_S
        for w in self.workers:
            try:
                w.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
            w.stdin.close()
        if dist.is_initialized():
            dist.destroy_process_group()


class _Held:
    """Rank 0's marginals of one call, with the call's sequence number."""

    __slots__ = ("seq", "marginals", "__weakref__")

    def __init__(self, seq: int, marginals):
        self.seq, self.marginals = seq, marginals


class Entry:
    replica_dim = 0

    def __init__(self, config: dict, traffic: dict, device):
        from cortex_tpu_torch import parallel

        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a world")
        self.parallel = parallel
        self.params = tuple(float(config[k]) for k in ("A", "Q", "H", "R"))
        n, R, T = int(config["ranks"]), int(traffic["replicas"]), int(config["T"])
        if T % n:
            raise ValueError(f"T = {T} does not split over {n} ranks")
        self.updates_per_call = R * (3 * T - 2)
        self.cost = costs.lgssm_call(R, T // n)
        kind = torch.device(device).type
        port = _free_port()
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on loopback
        spec = json.dumps({"config": config, "traffic": traffic, "device": kind,
                           "threads": torch.get_num_threads()})
        path = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
        workers = []
        for r in range(1, n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONPATH=path)
            workers.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), spec],
                                            stdin=subprocess.PIPE, stdout=2, env=env))
        world = _World(workers, None)
        weakref.finalize(self, world.stop)  # the workers live as long as this entry
        local = torch.cuda.current_device() if kind == "cuda" else 0
        parallel.init_distributed(f"tcp://localhost:{port}", n, 0, local_rank=local,
                                  device=kind, timeout=COLLECTIVE_TIMEOUT)
        self.mesh, self.sharding, world.commands = _join(config, traffic, kind)
        self.world = world
        self.blocks: list = []
        self.index: dict = {}
        self.seq = 0

    def pack(self, ring):
        self.world.command(PACK, len(ring))
        self.blocks = [_block(self.parallel, whole, self.sharding) for whole in ring.unbind(0)]
        self.index = {whole.data_ptr(): b for b, whole in enumerate(ring.unbind(0))}
        return ring

    def inputs(self, batch):
        return {"y": _time_major(batch)}

    def call(self, batch):
        b = self.index.get(batch.data_ptr())
        if b is None:
            raise ValueError("a call takes a batch of the packed ring: the ranks' blocks "
                             "were sent at set-up")
        seq, self.seq = self.seq, self.seq + 1
        self.world.command(CALL, b, seq)
        out = _Held(seq, self.parallel.lgssm_smooth_time_sharded(self.blocks[b], *self.params,
                                                                 mesh=self.mesh))
        weakref.finalize(out, self.world.released.append, seq)
        return out

    def results(self, out):
        self.world.command(GATHER, 0, out.seq)
        mean, variance = out.marginals
        return {"mean": _time_major(self.parallel.gather(mean, self.sharding)),
                "variance": _time_major(self.parallel.gather(variance, self.sharding))}


def _time_major(x):
    """``x`` laid out time-major: a view of the same shape and values."""
    return x.t().contiguous().t()


def _block(parallel, whole, sharding):
    """This rank's block of one batch, broadcast whole from rank 0."""
    dist.broadcast(whole, src=0)
    return parallel.shard(whole, sharding)


def build(config: dict, traffic: dict, device) -> Entry:
    return Entry(config, traffic, device)


def _orphaned() -> None:
    """End this worker when rank 0 is gone: its end of our standard input
    closes.  Reads the descriptor itself: a read through ``sys.stdin`` would
    hold its lock at the interpreter's shutdown."""
    while os.read(0, 1 << 16):
        pass
    os._exit(1)


def _serve(spec: dict) -> None:
    """Ranks 1..n-1: join the world, then do what each command says."""
    from cortex_tpu_torch import parallel

    threading.Thread(target=_orphaned, daemon=True).start()
    torch.set_num_threads(int(spec["threads"]))
    config, traffic, kind = spec["config"], spec["traffic"], spec["device"]
    parallel.init_distributed(device=kind, timeout=COLLECTIVE_TIMEOUT)
    mesh, sharding, commands = _join(config, traffic, kind)
    params = tuple(float(config[k]) for k in ("A", "Q", "H", "R"))
    shape = (int(traffic["replicas"]), int(config["T"]))
    blocks, outputs = [], {}
    cmd = torch.zeros(COMMAND, dtype=torch.int64)
    while True:
        dist.broadcast(cmd, src=0, group=commands)
        op, b, seq, n = cmd[:4].tolist()
        for done in cmd[4:4 + n].tolist():
            outputs.pop(done, None)
        if op == PACK:
            blocks = [_block(parallel, torch.empty(shape, device=mesh.device), sharding)
                      for _ in range(b)]
        elif op == CALL:
            outputs[seq] = parallel.lgssm_smooth_time_sharded(blocks[b], *params, mesh=mesh)
        elif op == GATHER:
            for part in outputs[seq]:
                parallel.gather(part, sharding)
        elif op == STOP:
            break
        else:
            raise ValueError(f"unknown command {op}")
    # Leave without shutting the groups down: NCCL's shutdown may wait for
    # every rank's, and rank 0 shuts its own down once the workers are gone.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _serve(json.loads(sys.argv[1]))
