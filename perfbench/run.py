#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/`` and
the port, ``cortex_tpu_torch/``, on a machine with the card(s) the cell asks
for.  Set-up (imports, the kernels' build or load, the ring of inputs, the
entry, warm-up) counts from the start of this script.  ``--trace 0`` reports
the cell's end-to-end metrics; ``--trace 1`` its per-layer metrics, from the
same loop with ``torch.profiler`` on for its last seconds.

The last lines on standard error are the numbers compared, each beside its
limit; the last line on standard output is one JSON object.  Without a card,
or with fewer than the cell asks for, it exits 2 and prints no result; if JAX
or the JAX package was loaded, it exits 3 and prints no result.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

# Set-up counts from the start of this script.
STARTED = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache at a fixed path inside the checkout.
CACHE = ROOT / "build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def _finite(obj):
    """``obj`` with every float that is not finite written as a string."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    from cortex_tpu_torch import _build

    _build.set_build_dir(CACHE / "cortex_tpu_torch")
    try:
        outcome = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                   STARTED)
    except harness.BannedModules as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 3
    for note in outcome.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, check in outcome.checks.items():
        verdict = "ok" if check["value"] <= check["limit"] else "FAILS"
        print(f"check {name} {check['value']!r} limit {check['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(outcome.result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
