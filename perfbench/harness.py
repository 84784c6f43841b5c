"""Run one cell of ``BENCHMARK.json`` once: set-up, a closed loop over a
measured window, the check of what the loop produced, and the metrics.

Everything a cell needs is found by name (paths relative to the root that
holds ``BENCHMARK.json``):

- the configuration: the ``file`` its entry in ``configs`` names; its
  ``reference`` key names ``perfbench/configs/<reference>.py``;
- the traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``entry`` key
  names ``perfbench/entries/<entry>.py``, the system under test, and whose
  ``inputs`` key names ``perfbench/inputs/<inputs>.py``, what its rows hold;
- each metric: ``perfbench/metrics/<metric>.py``, whose ``read(run)`` returns
  the metric's value from :class:`Run`, or ``None`` where it finds nothing
  to read (the metric is then left out of the line).

The loop is closed, with one batch in flight: each call's results are
complete on the card before the next call is made.  Each call takes the next
batch of the ring (:mod:`perfbench.traffic`).  A sample of the calls, drawn
from the seed, keeps its results, which are judged against the float64
reference once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import devtrace, traffic as traffic_gen

BANNED = ("jax", "jaxlib", "flax", "cortex_tpu")
# The traced parts of a --trace 1 run: the last seconds of its window, the
# device alone first, then the host too for the shorter last share.
TRACE_SECONDS = 2.0
LABELLED_SHARE = 0.25
# Event pairs made ahead of the window: its seconds over the least time a call
# took in warm-up, with this much to spare, and no more than CLOCK_PAIRS.
CLOCK_SPARE = 1.3
CLOCK_PAIRS = 4096
WARM_TIMED = 2  # warm-up calls timed one by one, to size the ring of pairs
JUDGE_THREADS = 4


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (any file name)."""
    name = f"perfbench_{path.parent.name}_{re.sub(r'\W', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object  # the entry module
    inputs: object  # the inputs-kind module
    reference: object  # the reference module
    metrics: List[dict]  # every metric of the spec that this cell reports
    root: Path

    def metrics_of(self, kind: str) -> List[dict]:
        return [m for m in self.metrics if m["kind"] == kind]


def find_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files loaded."""
    root = Path(root)
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    bench = root / "perfbench"
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in spec[kind] if workload in m.get("workloads", [workload])]
    return Cell(name=workload, chips=int(cell["chips"]), config=config, traffic=traffic,
                entry=load_module(bench / "entries" / f"{traffic['entry']}.py"),
                inputs=load_module(bench / "inputs" / f"{traffic['inputs']}.py"),
                reference=load_module(bench / "configs" / f"{config['reference']}.py"),
                metrics=metrics, root=root)


def reader(cell: Cell, metric: str):
    return load_module(cell.root / "perfbench" / "metrics" / f"{metric}.py")


@dataclass
class Part:
    """One stretch of the loop."""
    calls: int = 0
    seconds: float = 0.0
    call_s: List[float] = field(default_factory=list)  # each call, until its results are complete
    host_s: List[float] = field(default_factory=list)  # each call, until it returned


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    entry: object  # the built entry: updates_per_call, cost
    setup_s: float
    window: Part  # the loop without the profiler
    trace: Optional[devtrace.Trace] = None  # the traced part (--trace 1)


class Sample:
    """A uniform sample of ``k`` calls of the window, drawn from the seed
    (reservoir sampling), each kept with its batch and its outputs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(int(seed)), []

    def offer(self, call: int, batch: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((call, batch, out))
        else:
            j = self.rng.randrange(call + 1)
            if j < self.k:
                self.kept[j] = (call, batch, out)


class Clock:
    """Times each call on the card by a pair of CUDA events: the first is
    recorded on the idle stream just before the call, the second after it
    returns, and the loop waits on the second before the next call.  Making an
    event costs some 15 us, so a ring of at most ``CLOCK_PAIRS`` pairs is made
    at set-up; their times are read after the window, or, in a window of more
    calls, each time the ring comes round, between two calls."""

    def __init__(self, n: int):
        self.pairs = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(min(n, CLOCK_PAIRS))]
        for begin, end in self.pairs:  # the first record makes each event on the card
            begin.record()
            end.record()
        torch.cuda.synchronize()
        self.times: List[float] = []

    def _read(self, n: int) -> List[float]:
        return [begin.elapsed_time(end) / 1e3 for begin, end in self.pairs[:n]]

    def pair(self, k: int):
        """The pair of the loop's ``k``-th call."""
        n = len(self.pairs)
        if k and k % n == 0:
            self.times += self._read(n)
        return self.pairs[k % n]

    def finish(self, calls: int) -> List[float]:
        """Every call's time, once the loop's ``calls`` calls are complete."""
        times = self.times + self._read(calls - len(self.times))
        self.times = []
        assert len(times) == calls, (len(times), calls)
        return times


def _loop(entry, batches, seconds: float, sample: Sample, first: int, clock: Optional[Clock],
          span: Callable) -> Part:
    part = Part()
    n = len(batches)
    i = first
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        b = i % n
        k = i - first
        if clock is not None:
            begin, end = clock.pair(k)
            begin.record()
        h0 = time.perf_counter()
        with span("bench.call"):
            out = entry.call(batches[b])
        h1 = time.perf_counter()
        if clock is not None:
            end.record()
            with span("bench.wait"):
                end.synchronize()
        else:
            part.call_s.append(time.perf_counter() - h0)
        part.host_s.append(h1 - h0)
        sample.offer(i, b, out)
        i += 1
        if time.perf_counter() >= deadline:
            break
    part.seconds = time.perf_counter() - t0
    part.calls = i - first
    if clock is not None:
        part.call_s = clock.finish(part.calls)
    return part


def _no_span(name):
    return contextlib.nullcontext()


class BannedModules(RuntimeError):
    """JAX or the JAX package was loaded in the process that prints the result."""


def banned_modules() -> List[str]:
    """The top-level names of ``sys.modules`` that are JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


@dataclass
class Outcome:
    result: dict  # the line to print
    checks: Dict[str, dict]
    notes: List[str]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, wrap: Optional[Callable] = None) -> Outcome:
    """Run ``cell`` once on ``device``; ``started`` is the host clock at the
    start of the process (set-up counts from there).  ``wrap(entry)``, for
    tests and controls, may replace the built entry."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    config, traffic = cell.config, cell.traffic
    marks = [time.perf_counter()]
    ring = traffic_gen.make_ring(cell.inputs, config, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    entry = cell.entry.build(config, traffic, device)
    if wrap is not None:
        entry = wrap(entry)
    packed = entry.pack(ring)
    del ring
    batches = list(packed.unbind(0))
    judged = int(traffic["judged_calls"])
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    # Warm-up: every shape of the window, with as many outputs alive at once
    # as the window keeps (the sample, the last call's and the current one's).
    held = [entry.call(batches[i % len(batches)]) for i in range(judged + 2)]
    if cuda:
        torch.cuda.synchronize()
    del held
    least = math.inf
    for i in range(WARM_TIMED):
        t = time.perf_counter()
        entry.call(batches[i % len(batches)])
        if cuda:
            torch.cuda.synchronize()
        least = min(least, time.perf_counter() - t)
    marks.append(time.perf_counter())
    clock = None
    if cuda:
        clock = Clock(math.ceil(CLOCK_SPARE * seconds / least))
    marks.append(time.perf_counter())
    setup_s = marks[-1] - started
    notes: List[str] = [
        ("set-up: start to here {:.3f} s, ring {:.3f} s, entry {:.3f} s, warm-up {:.3f} s, "
         "{} event pairs {:.3f} s").format(
            marks[0] - started, *(b - a for a, b in zip(marks[:3], marks[1:4])),
            len(clock.pairs) if clock else 0, marks[4] - marks[3])]

    sample = Sample(judged, seed)
    trace_s = min(TRACE_SECONDS, seconds / 2) if trace else 0.0
    window = _loop(entry, batches, seconds - trace_s, sample, 0, clock, _no_span)
    tr = labels = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        first = window.calls
        with profile(activities=device_only) as prof:
            traced = _loop(entry, batches, trace_s * (1 - LABELLED_SHARE), sample, first, clock,
                           _no_span)
        tr = devtrace.from_profiler(prof, traced.calls, labelled=False)
        del prof
        first += traced.calls
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(devtrace.WINDOW):
                named = _loop(entry, batches, trace_s * LABELLED_SHARE, sample, first, clock,
                              record_function)
        labels = devtrace.from_profiler(prof, named.calls)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    banned = banned_modules()
    if banned:
        raise BannedModules("the run loaded JAX or the JAX package: " + ", ".join(banned))

    # The check, on the CPU in float64, once the program's state is freed.
    kept = [(call, {k: v.detach().cpu() for k, v in entry.results(out).items()},
             {k: v.cpu() for k, v in entry.inputs(batches[b]).items()})
            for call, b, out in sample.kept]
    run = Run(cell=cell, entry=entry, setup_s=setup_s, window=window, trace=tr)
    del sample, batches, packed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(JUDGE_THREADS, threads))
    t_judge = time.perf_counter()
    worst: Dict[str, float] = {}
    wrong = 0
    limits = config["limits"]
    for call, got, inputs in kept:
        want = cell.reference.reference(config, inputs)
        nums = cell.reference.compare(config, got, want)
        wrong += any(not nums[k] <= limits[k] for k in nums)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    torch.set_num_threads(threads)
    notes.append(f"judged {len(kept)} calls ({sorted(c for c, _, _ in kept)}) "
                 f"in {time.perf_counter() - t_judge:.3f} s")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    correct = bool(kept) and set(worst) == set(limits) and wrong == 0

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics_of(kind):
        value = reader(cell, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    calls = window.calls + (tr.calls + labels.calls if tr else 0)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": calls, "failed": wrong, "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": labels.idle_gaps()}
        notes.append(f"traced, device alone: {tr.calls} calls in {tr.window_s:.3f} s "
                     f"({tr.calls / tr.window_s:.1f}/s; untraced {window.calls / window.seconds:.1f}/s;"
                     f" with the host's operations {labels.calls / labels.window_s:.1f}/s)")
    notes.append(f"{calls} calls, {window.calls} untraced in {window.seconds:.3f} s; "
                 f"set-up {setup_s:.3f} s")
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return Outcome(result=result, checks=checks, notes=notes)
