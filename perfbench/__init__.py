"""The benchmark of ``cortex_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
a cell is made of is found by its name (see :mod:`perfbench.harness`):

- ``configs/<config>.json``: the sizes of a configuration, its limits, and
  the name of its plain reference, ``configs/<reference>.py``;
- ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  one generator, :mod:`perfbench.traffic`, the entry it drives and the kind
  of its inputs;
- ``inputs/<inputs>.py``: what a ring's rows hold, drawn from the seed;
- ``entries/<entry>.py``: how the port is called (the system under test);
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer.

:mod:`perfbench.peaks` and :mod:`perfbench.costs` are the yardstick: the
card's published peaks and the operations and bytes a call needs, counted
from its shapes.  Nothing here imports ``jax`` or ``cortex_tpu``, and the
references import nothing of the port.
"""
