#!/usr/bin/env python3
"""Read the numbers that a cell's limits are set from, on the card, at the
cell's own size: not part of a benchmark run.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--faults answer,half]

For each seed, on the seed's ring:

- the control: the configuration's reference, put in the program's place and
  computed in the precision its configuration names as ``control`` (the
  nearest below the one it states), judged like the program on as many
  batches as a run judges;
- each fault of :mod:`perfbench.faults` asked for: a short run (``--seconds``)
  with the timed path broken underneath.

Prints one JSON line a reading; ``--out`` also appends them to a file.
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(cell, seed: int, device: str) -> dict:
    import torch

    from perfbench import traffic as traffic_gen

    config, traffic = cell.config, cell.traffic
    entry = cell.entry.build(config, traffic, device)
    ring = traffic_gen.make_ring(cell.inputs, config, traffic, seed, device)
    picks = random.Random(int(seed)).sample(range(len(ring)), int(traffic["judged_calls"]))
    worst = {}
    for b in picks:
        inputs = entry.inputs(entry.pack(ring[b:b + 1])[0])
        got = cell.reference.reference(config, inputs, config["control"])
        got = {k: v.cpu() for k, v in got.items()}
        want = cell.reference.reference(config, {k: v.cpu() for k, v in inputs.items()})
        for k, v in cell.reference.compare(config, got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    del ring
    if device == "cuda":
        torch.cuda.synchronize()
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        lines.append({"workload": cell.name, "seed": seed,
                      "reading": "control:" + cell.config["control"],
                      "numbers": control_readings(cell, seed, "cuda")})
        print(json.dumps(lines[-1]), flush=True)
        for name in filter(None, args.faults.split(",")):
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                   time.perf_counter(), wrap=faults.FAULTS[name])
            lines.append({"workload": cell.name, "seed": seed, "reading": "fault:" + name,
                          "correct": out.result["correct"],
                          "numbers": {k: c["value"] for k, c in out.checks.items()}})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
