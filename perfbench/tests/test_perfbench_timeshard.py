"""The time-sharded cell on the CPU: its files found by name, its entry
rehearsed through ``harness.run_cell`` in a world of four gloo ranks (rank 0
this process) at a tiny size, faults in one rank's block caught, a lost rank
failing the run at once, the control failing the limits, its counts, its
readers and its plain reference."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cortex_tpu_torch.utils import spans
from perfbench import control, costs, devtrace, harness
from perfbench.tests.helpers import BENCH, make_root, run

ROOT = BENCH.parent
CELL = "lgssm.timeshard-4chip"
TINY_CELL = "lgssm-tiny.timeshard"
T, R, RANKS = 256, 8, 4
NEW_METRICS = ["parallel_us_per_call", "collective_us_per_call", "collective_bytes_per_call",
               "nccl_device_share", "msg_updates_per_s.timeshard"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_root(tmp: Path) -> Path:
    config = json.loads((BENCH / "configs" / "lgssm_long.json").read_text())
    config.update(name="lgssm-tiny", T=T)
    mix = json.loads((BENCH / "traffic" / "timeshard-4chip.json").read_text())
    mix.update(replicas=R)
    return make_root(tmp, cells={TINY_CELL: ("lgssm-tiny", "tiny-timeshard")},
                     traffic={"tiny-timeshard": mix},
                     configs=[("lgssm-tiny", json.dumps(config))])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp("timeshard"))


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_the_cell_is_found_with_its_files():
    cell = harness.find_cell(ROOT, CELL)
    assert cell.chips == RANKS == cell.config["ranks"]
    assert cell.config["T"] == 65536 and cell.traffic["replicas"] == 10000
    assert cell.traffic["ring_batches"] == 2 and cell.traffic["judged_calls"] == 2
    names = {m["name"] for m in cell.metrics}
    assert set(NEW_METRICS) | {"call_p95_ms", "setup_s", "host_us_per_call",
                               "launches_per_call", "device_idle_share", "step_mfu"} <= names
    assert "msg_updates_per_s" not in names
    for m in cell.metrics:
        assert callable(harness.reader(cell, m["name"]).read)
    # Every new metric is listed for this cell alone.
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert all(m.get("workloads") == [CELL] for m in spec["per_layer"] if m["name"] in NEW_METRICS)


def test_every_cell_of_the_spec_is_found_and_every_metric_has_its_reader():
    """What ``test_perfbench_harness`` checks of the one-card cells, for
    every cell: its files found, a reader for each of its metrics, and the
    spec's metrics and the readers' files one to one."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        assert cell.chips == w["chips"] in (1, RANKS)
        for m in cell.metrics:
            assert callable(harness.reader(cell, m["name"]).read)
        assert callable(cell.inputs.make)
    names = {m["name"] for kind in ("end_to_end", "per_layer") for m in spec[kind]}
    assert names == {p.stem for p in (BENCH / "metrics").glob("*.py")}


def test_a_sound_run_is_correct_with_the_global_and_per_rank_counts(root):
    seen = []

    def keep_counts(entry):
        seen.append((entry.updates_per_call, entry.cost, len(entry.world.workers)))
        return entry

    out = run(root, TINY_CELL, seed=2**31 + 18, seconds=0.5, wrap=keep_counts)
    res = out.result
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 4
    assert set(res["metrics"]) == {"call_p95_ms", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    # R (3T - 2) updates over the whole chain; the least time of one rank's block.
    assert seen == [(R * (3 * T - 2), costs.lgssm_call(R, T // RANKS), RANKS - 1)]


def test_a_traced_run_is_correct_and_reports_what_it_can_read(root):
    res = run(root, TINY_CELL, seed=5, seconds=0.6, trace=True).result
    assert res["correct"] is True
    # On the CPU the trace holds no device record: the device and span readers read nothing.
    assert set(res["metrics"]) == {"host_us_per_call", "step_mfu"}
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and all(name.startswith("bench.") for name, _ in gaps)


class _Broken:
    """``entry`` with other ``call`` or ``results``."""

    def __init__(self, entry, **methods):
        self._entry = entry
        self.__dict__.update(methods)

    def __getattr__(self, name):
        return getattr(self._entry, name)


def _zeroed(entry):
    """Rank 0's block of every call's means zeroed where it is produced."""
    def call(batch):
        out = entry.call(batch)
        out.marginals.mean.zero_()
        return out
    return _Broken(entry, call=call)


def _swapped(entry):
    """The blocks of ranks 1 and 2 exchanged in the whole results."""
    def results(out):
        got = entry.results(out)
        step = T // RANKS
        for v in got.values():
            first = v[:, step:2 * step].clone()
            v[:, step:2 * step] = v[:, 2 * step:3 * step]
            v[:, 2 * step:3 * step] = first
        return got
    return _Broken(entry, results=results)


@pytest.mark.parametrize("fault", [_zeroed, _swapped], ids=["zeroed", "swapped"])
def test_a_wrong_block_from_one_rank_makes_the_run_incorrect(root, fault):
    out = run(root, TINY_CELL, seed=7, wrap=fault)
    assert out.result["correct"] is False
    assert out.checks["mean_err"]["value"] > out.checks["mean_err"]["limit"]


LOSE_A_RANK = """
import os, signal, sys, time, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from perfbench import harness

def lose_rank_2(entry):
    workers = entry.world.workers
    print(" ".join(str(w.pid) for w in workers), flush=True)
    call, n = entry.call, [0]

    def dying(batch):
        n[0] += 1
        if n[0] == 3:
            os.kill(workers[1].pid, signal.SIGKILL)
        return call(batch)
    entry.call = dying
    return entry

cell = harness.find_cell(sys.argv[2], sys.argv[3])
harness.run_cell(cell, 11, 30.0, False, "cpu", time.perf_counter(), wrap=lose_rank_2)
print("finished", flush=True)
"""


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return False
    return state not in ("Z", "X")


def test_a_lost_rank_fails_the_run_at_once_and_leaves_no_worker(root):
    start = time.monotonic()
    out = subprocess.run([sys.executable, "-c", LOSE_A_RANK, str(ROOT), str(root), TINY_CELL],
                         capture_output=True, text=True, timeout=120)
    elapsed = time.monotonic() - start
    pids = [int(p) for p in out.stdout.splitlines()[0].split()]
    assert out.returncode == 1 and "finished" not in out.stdout
    # Rank 0's watch saw a worker exit, or its own exchange with the lost rank failed.
    assert re.search(r"rank [123] exited with|Connection reset by peer", out.stderr), \
        out.stderr[-2000:]
    assert elapsed < 60.0  # rank 0's watch: far under the collective timeout
    time.sleep(0.5)
    assert len(pids) == RANKS - 1 and not any(_alive(p) for p in pids)


def test_the_workers_leave_when_the_run_ends(root):
    pids = []

    def note(entry):
        pids.extend(w.pid for w in entry.world.workers)
        return entry

    run(root, TINY_CELL, seed=3, wrap=note)
    assert len(pids) == RANKS - 1 and not any(_alive(p) for p in pids)
    assert not torch.distributed.is_initialized()


def test_the_control_in_the_programs_place_fails_the_limits(root):
    cell = harness.find_cell(root, TINY_CELL)
    nums = control.control_readings(cell, 9, "cpu")
    assert set(nums) == set(cell.config["limits"])
    assert all(nums[k] > cell.config["limits"][k] for k in nums), nums


# -- the readers, on synthetic runs ----------------------------------------------------------


def _record(i, layers, counts):
    return spans.CallRecord(i, "parallel.time_sharded", 0, sum(layers.values()), layers, counts)


RECORDS = [_record(0, {"parallel": 30_000, "collective": 4_000},
                   {"collective.calls": 2, "collective.bytes": 320_000}),
           _record(1, {"parallel": 50_000, "collective": 6_000},
                   {"collective.calls": 2, "collective.bytes": 320_000}),
           _record(2, {"parallel": 1_000_000}, {})]  # the labelled part's


def _run(kernels=(), calls=2, busy_s=0.5, window_calls=10, seconds=5.0):
    trace = devtrace.Trace(window_s=1.0, busy_s=busy_s, calls=calls, kernels=list(kernels))
    entry = type("E", (), {"updates_per_call": 7})()
    return harness.Run(cell=None, entry=entry, setup_s=1.0,
                       window=harness.Part(calls=window_calls, seconds=seconds), trace=trace)


def test_the_readers_of_the_new_metrics(monkeypatch):
    monkeypatch.setattr(spans, "calls", lambda: list(RECORDS))
    nccl = [("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.01),
            ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.015),
            ("void at::native::vectorized_elementwise_kernel<4>", 0.4)]
    run_ = _run(nccl)
    assert reader("parallel_us_per_call").read(run_) == pytest.approx(40.0)
    assert reader("collective_us_per_call").read(run_) == pytest.approx(5.0)
    assert reader("collective_bytes_per_call").read(run_) == pytest.approx(320_000.0)
    assert reader("nccl_device_share").read(run_) == pytest.approx(5.0)
    assert reader("msg_updates_per_s.timeshard").read(run_) == pytest.approx(14.0)
    # No NCCL kernel, or no device record at all: no share.
    assert reader("nccl_device_share").read(_run(nccl[2:])) is None
    assert reader("nccl_device_share").read(_run(busy_s=0.0)) is None


@pytest.mark.parametrize("name", NEW_METRICS[:3])
def test_the_span_readers_read_nothing_from_a_program_without_those_spans(monkeypatch, name):
    """A port from before the parallel and collective spans and counters
    leaves no call record in this cell, and has no collective counters."""
    monkeypatch.setattr(spans, "calls", list)
    assert reader(name).read(_run()) is None
    monkeypatch.setattr(spans, "calls", lambda: list(RECORDS))
    counts = {k: v for k, v in spans.counts().items() if not k.startswith("collective.")}
    monkeypatch.setattr(spans, "counts", lambda: counts)
    if name == "collective_bytes_per_call":
        assert reader(name).read(_run()) is None
    else:
        assert reader(name).read(_run()) is not None


# -- the plain reference ---------------------------------------------------------------------


def _reference(name):
    return harness.load_module(BENCH / "configs" / f"{name}.py")


@pytest.mark.parametrize("params", [(1.0, 1.0, 1.0, 1.0), (0.9, 0.3, 1.2, 1.5)])
def test_the_long_reference_is_the_lgssm_reference_in_float64(params):
    y = torch.randn(5, 300, generator=torch.Generator().manual_seed(4)).cumsum(-1)
    got = _reference("lgssm_long_reference").smooth(y, *params)
    want = _reference("lgssm_reference").smooth(y, *params)
    for k in ("mean", "variance"):
        assert got[k].dtype == torch.float64
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


def test_the_long_compare_reads_zero_on_itself_infinite_on_a_wrong_answer():
    ref = _reference("lgssm_long_reference")
    config = json.loads((BENCH / "configs" / "lgssm_long.json").read_text())
    y = torch.randn(6, 2500, generator=torch.Generator().manual_seed(5)).cumsum(-1)
    want = ref.reference(config, {"y": y})
    assert ref.compare(config, want, want) == {"mean_err": 0.0, "var_err": 0.0}
    short = dict(want, mean=want["mean"][:3])
    assert ref.compare(config, short, want)["mean_err"] == float("inf")
    nan = dict(want, variance=want["variance"].clone())
    nan["variance"][2, 2100] = float("nan")  # in the third slice of steps
    assert ref.compare(config, nan, want)["var_err"] == float("inf")
    # The float32 sequential smoother passes; the bfloat16 control does not.
    nums32 = ref.compare(config, ref.reference(config, {"y": y}, "float32"), want)
    nums16 = ref.compare(config, ref.reference(config, {"y": y}, "bfloat16"), want)
    assert all(nums32[k] <= config["limits"][k] < nums16[k] for k in nums32), (nums32, nums16)


def test_the_long_reference_reads_either_layout_alike():
    """The entry hands its inputs and answers over time-major: the same
    values read the same numbers as laid out one replica a row."""
    ref = _reference("lgssm_long_reference")
    config = json.loads((BENCH / "configs" / "lgssm_long.json").read_text())
    y = torch.randn(7, 700, generator=torch.Generator().manual_seed(6)).cumsum(-1)
    want = ref.reference(config, {"y": y})
    want_t = ref.reference(config, {"y": y.t().contiguous().t()})
    for k in ("mean", "variance"):
        assert torch.equal(want[k], want_t[k])
    got = ref.reference(config, {"y": y}, "float32")
    got = {k: v.contiguous() for k, v in got.items()}
    got_t = {k: v.t().contiguous().t() for k, v in got.items()}
    assert got["mean"].stride() != got_t["mean"].stride()
    nums = ref.compare(config, got, want)
    assert ref.compare(config, got_t, want) == nums and nums["mean_err"] > 0


def test_the_long_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((BENCH / "configs" / "lgssm_long_reference.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0] if not node.level else "perfbench")
    assert tops <= {"__future__", "functools", "typing", "torch"}, tops
