"""The readers of the program's spans and counters, on synthetic runs."""

from __future__ import annotations

import sys

import pytest

from cortex_tpu_torch.utils import spans
from perfbench import devtrace, harness, spanreads
from perfbench.tests.helpers import BENCH

LAYERS = {"boundary": "boundary", "model": "model", "compiled": "compiled", "rules": "rules",
          "ops": "ops", "launch": "launch"}
PER_CALL = [f"{layer}_us_per_call" for layer in LAYERS] + ["program_us_per_call",
                                                           "h2d_copies_per_call"]
SETUP = {"setup_import_s": "setup.import", "setup_build_s": "setup.kernel_build"}


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def record(i, start, layers, counts=None):
    return spans.CallRecord(i, "model.x", start, start + sum(layers.values()), layers,
                            counts or {})


# Three calls of the device-only part, then one of the labelled part.
RECORDS = [
    record(0, 0, {"model": 4_000, "boundary": 2_000, "ops": 10_000, "launch": 20_000},
           {"copy.h2d.calls": 1, "copy.h2d.bytes": 40}),
    record(1, 50_000, {"model": 6_000, "boundary": 4_000, "ops": 14_000, "launch": 24_000,
                       "compiled": 1_000, "rules": 2_000}),
    record(2, 90_000, {"model": 5_000, "boundary": 3_000, "ops": 12_000, "launch": 22_000},
           {"copy.h2d.calls": 2}),
    record(3, 200_000, {"model": 900_000}),
]


def run_of(calls=3, busy_s=0.25):
    trace = devtrace.Trace(window_s=1.0, busy_s=busy_s, calls=calls)
    return harness.Run(cell=None, entry=None, setup_s=1.0, window=harness.Part(), trace=trace)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(spans, "calls", lambda: list(RECORDS))
    monkeypatch.setattr(spans, "setup", lambda: {"setup.import": 0.25,
                                                 "setup.kernel_build": 0.03})


def test_the_per_call_readers_average_the_device_only_parts_calls(records):
    run = run_of()
    assert reader("model_us_per_call").read(run) == pytest.approx(5.0)
    assert reader("boundary_us_per_call").read(run) == pytest.approx(3.0)
    assert reader("ops_us_per_call").read(run) == pytest.approx(12.0)
    assert reader("launch_us_per_call").read(run) == pytest.approx(22.0)
    assert reader("compiled_us_per_call").read(run) == pytest.approx(1 / 3)
    assert reader("rules_us_per_call").read(run) == pytest.approx(2 / 3)
    assert reader("program_us_per_call").read(run) == pytest.approx(43.0)
    assert reader("h2d_copies_per_call").read(run) == pytest.approx(1.0)
    layers = sum(reader(f"{layer}_us_per_call").read(run) or 0.0 for layer in LAYERS)
    assert layers == pytest.approx(reader("program_us_per_call").read(run))
    # A layer that no call has reads nothing.
    assert spanreads.layer_us(run, "setup") is None


def test_the_set_up_readers_read_the_set_up_spans(records):
    run = run_of()
    assert reader("setup_import_s").read(run) == 0.25
    assert reader("setup_build_s").read(run) == 0.03


@pytest.mark.parametrize("name", PER_CALL + list(SETUP))
@pytest.mark.parametrize("empty", ["untraced", "no device record", "no call record"])
def test_every_reader_reads_nothing_in_an_empty_run(records, monkeypatch, name, empty):
    run = run_of(busy_s=0.0 if empty == "no device record" else 0.25)
    if empty == "untraced":
        run.trace = None
    if empty == "no call record":
        monkeypatch.setattr(spans, "calls", list)
        monkeypatch.setattr(spans, "setup", dict)
    assert reader(name).read(run) is None


@pytest.mark.parametrize("name", PER_CALL + list(SETUP))
def test_every_reader_reads_nothing_from_a_program_without_spans(records, monkeypatch, name):
    """A checkout whose port has no spans module: no value, no error."""
    import cortex_tpu_torch.utils

    assert reader(name).read(run_of()) is not None
    monkeypatch.delattr(cortex_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "cortex_tpu_torch.utils.spans", None)
    assert reader(name).read(run_of()) is None
