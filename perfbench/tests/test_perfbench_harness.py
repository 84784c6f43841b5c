"""The harness on the CPU: cells found by name, a cell and a metric added as
files alone, faults under the timed path caught, the trace reduced, no JAX
anywhere in what runs on the card, and no result without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import devtrace, faults, harness
from perfbench.tests.helpers import BENCH, SPEC, TINY, TINY_CELLS, make_root, run

ROOT = BENCH.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def test_every_cell_of_the_spec_is_found_with_its_files():
    for w in SPEC["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        assert cell.chips == w["chips"] == 1
        for m in cell.metrics:
            assert callable(harness.reader(cell, m["name"]).read)
        assert callable(cell.inputs.make)
    names = {m["name"] for kind in ("end_to_end", "per_layer") for m in SPEC[kind]}
    assert names == {p.stem for p in (BENCH / "metrics").glob("*.py")}


def test_the_ring_is_the_seeds_alone_and_outgrows_l2():
    from perfbench import traffic

    for w in SPEC["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        n, R, T = cell.traffic["ring_batches"], cell.traffic["replicas"], cell.config["T"]
        itemsize = 8 if cell.traffic["inputs"] == "walk_symbols" else 4
        assert n * R * T * itemsize >= 256e6, w["name"]
    cell = harness.find_cell(ROOT, "hmm.vmp-4k")
    cfg, kind = cell.config, cell.inputs
    small = {"inputs": "walk_symbols", "ring_batches": 3, "replicas": 5}
    a = traffic.make_ring(kind, cfg, small, 2**31 + 17, "cpu")
    assert torch.equal(a, traffic.make_ring(kind, cfg, small, 2**31 + 17, "cpu"))
    assert not torch.equal(a, traffic.make_ring(kind, cfg, small, 2**31 + 18, "cpu"))
    assert a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < cfg["M"]


# The end-to-end metrics of each tiny cell: those of the cell it stands for.
END_TO_END = {"lgssm.tiny-fused": {"msg_updates_per_s", "call_p95_ms", "setup_s"},
              "lgssm.tiny-graph": {"msg_updates_per_s", "call_p95_ms", "setup_s"},
              "hmm.tiny-vmp": {"call_p95_ms", "setup_s"}}


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_a_sound_run_is_correct_and_reports_its_end_to_end_metrics(root, workload):
    out = run(root, workload)
    res = out.result
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == END_TO_END[workload]
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(root, workload):
    res = run(root, workload, seconds=0.4, trace=True).result
    assert res["correct"] is True
    # On the CPU the trace holds no device record: the device readers read nothing.
    rate = {"msg_updates_per_s.vmp"} if workload == "hmm.tiny-vmp" else set()
    assert set(res["metrics"]) == {"host_us_per_call", "step_mfu"} | rate
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    gaps = res["breakdown"]["idle_gaps"]
    assert gaps and all(name.startswith("bench.") for name, _ in gaps)


FAULTY = [(w, f) for w in sorted(TINY_CELLS) for f in ("answer", "half")] + [
    ("hmm.tiny-vmp", "unchanged")]


@pytest.mark.parametrize("workload,fault", FAULTY)
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(root, workload, fault):
    out = run(root, workload, wrap=faults.FAULTS[fault])
    assert out.result["correct"] is False
    assert any(c["value"] > c["limit"] for c in out.checks.values())


def test_unchanged_needs_an_entry_with_iterations(root):
    with pytest.raises(ValueError):
        run(root, "lgssm.tiny-fused", wrap=faults.unchanged)


NEW_METRIC = '''"""calls_per_s: calls over the window's seconds."""


def read(run):
    return run.window.calls / run.window.seconds
'''

NEW_INPUTS = '''"""Stationary AR(1) rows: x[t] = 0.9 x[t-1] + N(0, 1)."""

import torch


def make(config, traffic, shape, gen, device):
    noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    for t in range(1, shape[-1]):
        noise[..., t] += 0.9 * noise[..., t - 1]
    return noise
'''


def test_a_cell_a_configuration_and_a_metric_added_as_files_alone(tmp_path):
    from perfbench import traffic

    config = json.loads((BENCH / "configs" / "lgssm.json").read_text())
    config.update(name="lgssm_ar", A=0.9, Q=0.5, R=2.0)
    mix = {"entry": "lgssm_smooth", "method": "scan", "inputs": "ar1",
           "replicas": 16, "ring_batches": 2, "judged_calls": 1}
    root = make_root(tmp_path, cells={"lgssm_ar.tiny-scan": ("lgssm_ar", "tiny-scan"),
                                      "lgssm.tiny-fused": ("lgssm", "tiny-fused")},
                     traffic={"tiny-scan": mix, "tiny-fused": TINY["tiny-fused"]}, configs=[("lgssm_ar", json.dumps(config))],
                     files=[("perfbench/metrics/calls_per_s.py", NEW_METRIC),
                            ("perfbench/inputs/ar1.py", NEW_INPUTS)])
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # A later cell joins the lists of the metrics it reports, as BENCHMARK.json entries.
    next(m for m in spec["end_to_end"] if m["name"] == "msg_updates_per_s")["workloads"].append(
        "lgssm_ar.tiny-scan")
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["lgssm_ar.tiny-scan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # Every file that was there is unchanged.
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (root / "perfbench" / path.relative_to(BENCH)).read_bytes() == \
                path.read_bytes()
    cell = harness.find_cell(root, "lgssm_ar.tiny-scan")
    assert cell.config["A"] == 0.9 and cell.traffic["method"] == "scan"
    ring = traffic.make_ring(cell.inputs, cell.config, cell.traffic, 4, "cpu")
    assert ring.shape == (2, 16, cell.config["T"])
    assert abs(float(ring[..., 1:].std())) < 4  # AR(1), not a random walk
    res = run(root, "lgssm_ar.tiny-scan").result
    assert res["correct"] is True
    assert set(res["metrics"]) == {"msg_updates_per_s", "call_p95_ms", "setup_s", "calls_per_s"}
    # Another cell does not report a metric listed for this one.
    assert "calls_per_s" not in run(root, "lgssm.tiny-fused").result["metrics"]


def test_the_trace_reduction_on_a_timeline_worked_by_hand():
    host = [(0, 100, devtrace.WINDOW), (0, 40, "bench.call"), (10, 30, "aten::einsum"),
            (40, 100, "bench.wait")]
    device = [(20, 50, "k1"), (45, 60, "k1"), (70, 80, "Memcpy DtoH"), (90, 130, "k2")]
    tr = devtrace.reduce(device, host, calls=2)
    assert tr.window_s == 100e-9
    assert tr.busy_s == pytest.approx(60e-9)  # [20, 60), [70, 80), [90, 100)
    assert sorted(tr.kernels) == [("k1", 15e-9), ("k1", 30e-9), ("k2", 10e-9)]
    assert tr.copies == [("Memcpy DtoH", 10e-9)]
    assert tr.idle_by_host == {"bench.call > aten::einsum": pytest.approx(20e-9),
                               "bench.wait": pytest.approx(20e-9)}
    # A device-only trace: its window spans every event it holds.
    runtime = [(15, 18, "cudaLaunchKernel"), (40, 44, "cudaLaunchKernel")]
    alone = devtrace.reduce(device, runtime, calls=2, labelled=False)
    assert alone.window_s == pytest.approx(115e-9)  # [15, 130)
    assert alone.busy_s == pytest.approx(90e-9)  # [20, 60), [70, 80), [90, 130)
    assert tr.device_ops()[0] == ["k1", pytest.approx(45e-9)]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                package = path.parent
                for _ in range(node.level - 1):
                    package = package.parent
                base = ".".join(package.relative_to(ROOT).parts)
                yield base + ("." + node.module if node.module else "")
                for a in node.names:
                    yield base + ("." + node.module if node.module else "") + "." + a.name
            else:
                yield node.module
                yield from (node.module + "." + a.name for a in node.names)


def _file_of(module: str):
    path = ROOT.joinpath(*module.split("."))
    for candidate in (path.with_suffix(".py"), path / "__init__.py"):
        if candidate.is_file():
            return candidate
    return None


def test_nothing_run_on_the_card_imports_jax_or_the_jax_package():
    # Every module that run.py can load: the harness's files, the files it
    # loads by name, and every module of this repository they import, in turn.
    todo = [BENCH / "run.py", BENCH / "control.py", *BENCH.glob("*.py"),
            *BENCH.glob("configs/*.py"), *BENCH.glob("entries/*.py"), *BENCH.glob("metrics/*.py"),
            *BENCH.glob("inputs/*.py")]
    seen, tops = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for module in _imports(path):
            tops.add(module.split(".")[0])
            found = _file_of(module)
            if found is not None:
                todo.append(found)
    assert any(p.parts[-2] == "ops" for p in seen)  # the port's modules were walked
    assert not tops & set(harness.BANNED), sorted(tops & set(harness.BANNED))


def test_a_run_loads_no_jax_in_its_process(tmp_path):
    root = make_root(tmp_path)
    code = ("import sys, time, torch; torch.set_num_threads(1); sys.path.insert(0, sys.argv[1]);"
            "from perfbench import harness;"
            "cell = harness.find_cell(sys.argv[2], 'lgssm.tiny-graph');"
            "harness.run_cell(cell, 3, 0.2, False, 'cpu', time.perf_counter());"
            "cell = harness.find_cell(sys.argv[2], 'hmm.tiny-vmp');"
            "harness.run_cell(cell, 3, 0.2, False, 'cpu', time.perf_counter());"
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "lgssm.fused-100k",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "lgssm.fused-100k",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_the_control_in_the_programs_place_fails_the_limits(root, workload):
    from perfbench import control

    cell = harness.find_cell(root, workload)
    nums = control.control_readings(cell, 9, "cpu")
    assert set(nums) == set(cell.config["limits"])
    assert any(nums[k] > cell.config["limits"][k] for k in nums), nums
