"""A checkout of the benchmark in a temporary directory, with cells of the
tests' own, and runs of it on the CPU."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from perfbench import harness

BENCH = Path(harness.__file__).resolve().parent
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

# Tiny mixes of each entry: what the CPU can hold in a test.
TINY = {
    "tiny-fused": {"entry": "lgssm_smooth", "method": "fused", "inputs": "random_walk",
                   "replicas": 24, "ring_batches": 3, "judged_calls": 2},
    "tiny-graph": {"entry": "lgssm_graph", "lower": True, "inputs": "random_walk",
                   "replicas": 24, "ring_batches": 3, "judged_calls": 2},
    "tiny-vmp": {"entry": "hmm_fit_vmp", "method": "fused", "inputs": "walk_symbols",
                 "dtype": "int64", "replicas": 24, "ring_batches": 3, "judged_calls": 2},
}
TINY_CELLS = {"lgssm.tiny-fused": ("lgssm", "tiny-fused"),
              "lgssm.tiny-graph": ("lgssm", "tiny-graph"),
              "hmm.tiny-vmp": ("hmm", "tiny-vmp")}
# The cell of the spec each tiny cell stands for: it reports what that cell reports.
LIKE = {"lgssm.tiny-fused": "lgssm.fused-10k", "lgssm.tiny-graph": "lgssm.graph-10k",
        "hmm.tiny-vmp": "hmm.vmp-4k"}


def make_root(tmp: Path, cells=TINY_CELLS, traffic=TINY, configs=(), files=()) -> Path:
    """A copy of the benchmark under ``tmp``, with the traffic files, the
    configurations (``(name, source_file_text)``) and other files
    (``(relative_path, text)``) added, and its cells appended to
    ``BENCHMARK.json``, each to the metrics listed for the cell it stands for
    (``LIKE``)."""
    shutil.copytree(BENCH, tmp / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    for name, body in traffic.items():
        (tmp / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(body))
    for name, text in configs:
        path = f"perfbench/configs/{name}.json"
        (tmp / path).write_text(text)
        spec["configs"].append({"name": name, "source": "test", "file": path, "reduced": [],
                                "why": "test"})
    for rel, text in files:
        (tmp / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp / rel).write_text(text)
    for name, (config, mix) in cells.items():
        spec["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                  "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if LIKE.get(name) in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def run(root: Path, workload: str, seed: int = 5, seconds: float = 0.3, trace: bool = False,
        wrap=None):
    cell = harness.find_cell(root, workload)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), wrap=wrap)
