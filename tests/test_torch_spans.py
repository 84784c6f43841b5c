"""The port's spans and counters (``cortex_tpu_torch.utils.spans``) on the CPU.

Off (no profiler session) a span is one shared object and nothing is
recorded; inside a ``torch.profiler`` session spans nest, their layers' self
times add up to the root's duration, and each appears in the profiler's
host events.  The three entry points that the benchmark's cells call each
make one call record a call, and the counters count what the program
uploads and launches.
"""

import json
import math
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cortex_tpu_torch.compile import CompiledInference
from cortex_tpu_torch.compile.tracing import profile_run
from cortex_tpu_torch.models import HMM, LGSSM, LGSSMChainBatched, make_chain_graph
from cortex_tpu_torch.ops import kernels
from cortex_tpu_torch.utils import spans, tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No call records from another test; inputs that are not tensors go to
    the CPU."""
    monkeypatch.setattr(tree, "DEFAULT_DEVICE", "cpu")
    spans.reset()
    yield
    spans.reset()


def _host_events(prof):
    """``(name, thread)`` of every host event of a finished profiler."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_thread_id()) for e in prof.profiler.kineto_results.events()
            if e.device_type() != cuda]


def test_the_gate_and_the_record_function_exist_in_torch():
    """The span's gate is the flag that torch's profiler sessions set, and
    what a span emits is the profiler's fast record function."""
    flag = sys.modules["torch.autograd.profiler"]
    assert spans._profiler is flag
    assert flag._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True
        assert torch.autograd._profiler_enabled()
    assert flag._is_profiler_enabled is False
    assert spans._RECORD is torch._C._profiler._RecordFunctionFast


def test_with_no_profiler_a_span_records_nothing_and_never_enters_the_profiler():
    record = mock.MagicMock()
    with mock.patch.object(spans, "_RECORD", record):
        first = spans.span("model.x")
        assert spans.span("ops.y") is first
        with first:
            with spans.span("ops.y"):
                pass
        LGSSM().smooth(torch.randn(3, 6), method="fused")
    record.assert_not_called()
    assert spans.calls() == []


@pytest.mark.parametrize("on", [False, True])
def test_an_exception_leaves_a_span_and_the_stack_unchanged(on):
    def body():
        with spans.span("model.x"):
            with spans.span("ops.y"):
                raise KeyError("inside")

    with profile(activities=[ProfilerActivity.CPU]) if on else mock.MagicMock():
        with pytest.raises(KeyError, match="inside"):
            body()
        assert spans._stack() == []
    assert [r.name for r in spans.calls()] == (["model.x"] if on else [])


def test_under_a_profiler_spans_nest_and_self_times_partition_the_root():
    names = ("model.a", "boundary.b", "ops.c", "launch.d", "ops.e")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("model.a"):
            with spans.span("boundary.b"):
                torch.ones(8).sum()
            with spans.span("ops.c"):
                with spans.span("launch.d"):
                    torch.ones(8) * 2
                torch.ones(8) + 1
            with spans.span("ops.e"):
                pass
        with spans.span("model.a"):
            pass
    records = spans.calls()
    assert [r.name for r in records] == ["model.a", "model.a"]
    assert [r.id for r in records] == [0, 1]
    first = records[0]
    assert set(first.layers) == {"model", "boundary", "ops", "launch"}
    assert all(ns >= 0 for ns in first.layers.values())
    assert sum(first.layers.values()) == first.end_ns - first.start_ns
    assert records[1].layers == {"model": records[1].end_ns - records[1].start_ns}
    events = _host_events(prof)
    # The calling thread: the one that ran the operations inside the spans.
    caller = {tid for n, tid in events if n == "aten::sum"}
    assert len(caller) == 1
    assert set(names) <= {n for n, tid in events if tid in caller}


def _chain_inputs(T=6, R=3):
    engine, x, yv, _ = make_chain_graph(T)
    compiled = CompiledInference(engine, x, LGSSMChainBatched(), lower=True)
    step = {v: i for i, v in enumerate(yv)}
    rows = torch.tensor([step[key[1]] for key in compiled.source_keys()])
    pack = torch.randn(R, T, generator=torch.Generator().manual_seed(2)).cumsum(1).t()[rows]
    return compiled, pack


ENTRIES = {
    "lgssm_smooth": (lambda: LGSSM(), "model.lgssm.smooth",
                     {"model", "boundary", "ops"}),
    "hmm_fit_vmp": (lambda: HMM(3, torch.full((3,), -math.log(3.0))), "model.hmm.fit_vmp",
                    {"model", "boundary", "ops"}),
    "compiled_run": (_chain_inputs, "compiled.run", {"compiled", "boundary", "rules"}),
}


def _call(kind, made):
    if kind == "lgssm_smooth":
        return made.smooth(torch.randn(4, 7).cumsum(1), method="fused")
    if kind == "hmm_fit_vmp":
        obs = torch.randint(0, 4, (5, 9), generator=torch.Generator().manual_seed(1))
        return made.fit_vmp(obs, 4, n_iterations=2, method="scan", pooled=True)
    compiled, pack = made
    return compiled.run({}, source_pack=pack, packed=True)


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_each_entry_point_of_the_cells_makes_one_call_record_a_call(kind):
    make, root, layers = ENTRIES[kind]
    made = make()
    _call(kind, made)  # a call with no profiler records nothing
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _call(kind, made)
    records = spans.calls()
    assert [r.name for r in records] == [root] * 3
    for r in records:
        assert set(r.layers) == layers
        assert sum(r.layers.values()) == r.end_ns - r.start_ns


def test_a_numpy_input_counts_its_upload_and_its_bytes():
    before = spans.counts()
    y = np.random.default_rng(0).normal(size=(3, 5))  # float64: float32 on the device
    out, = tree.as_tensors(y, device="meta")
    after = spans.counts()
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert after["copy.h2d.calls"] - before["copy.h2d.calls"] == 1
    assert after["copy.h2d.bytes"] - before["copy.h2d.bytes"] == 3 * 5 * 4
    tree.as_tensors(y)  # on the host: no upload
    assert spans.counts()["copy.h2d.calls"] == after["copy.h2d.calls"]
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("boundary.inputs"):
            tree.as_tensors(y, device="meta")
    record, = spans.calls()
    assert record.counts == {"copy.h2d.calls": 1, "copy.h2d.bytes": 60}


def test_the_kernels_launch_counts_are_the_registrys_launch_group():
    assert kernels.LAUNCHES is spans.counter_group("launch")
    assert set(kernels.LAUNCHES) == {"lgssm_smooth", "hmm_fb", "hmm_fb_counts", "hgf_filter",
                                     "lgssm_time_sharded"}
    before = kernels.LAUNCHES["hgf_filter"]
    kernels.LAUNCHES["hgf_filter"] += 2
    assert spans.counts()["launch.hgf_filter"] == before + 2
    kernels.LAUNCHES["hgf_filter"] = before


def test_set_up_spans_record_with_no_profiler_and_count_nested_ones_once():
    name = "setup.test_only"
    with spans.setup_span(name):
        with spans.setup_span(name):
            pass
    once = spans.setup()[name]
    assert once > 0
    with spans.setup_span(name):
        pass
    assert spans.setup()[name] > once
    assert spans.calls() == []
    assert spans.setup()["setup.import"] > 0  # the subpackages were imported


def test_a_set_up_span_inside_a_call_counts_to_its_setup_layer():
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.setup_span("setup.alone"):
            pass
        with spans.span("model.a"):
            with spans.setup_span("setup.inside"):
                pass
    record, = spans.calls()
    assert set(record.layers) == {"model", "setup"}


def test_records_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with spans.span("model.x"):
                pass
    assert [r.id for r in spans.calls()] == [0, 1]
    assert spans.counts()["spans.dropped"] == 3
    spans.reset()
    assert spans.calls() == [] and spans.counts()["spans.dropped"] == 0


def test_profile_runs_chrome_trace_holds_the_programs_spans(tmp_path):
    made = _chain_inputs()
    with profile_run(str(tmp_path)):
        _call("compiled_run", made)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"compiled.run", "boundary.inputs", "compiled.gather",
            "compiled.writeback"} <= names
    assert any(n.startswith("rules.") for n in names)
    assert [r.name for r in spans.calls()] == ["compiled.run"]
