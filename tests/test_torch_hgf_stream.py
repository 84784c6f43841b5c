"""The streaming HGF through the kernel's path, with a carried state, on the CPU.

``HGF.filter(c, state=st, method="fused")`` runs K4's plain version from the
given state on a CPU tensor (K4 itself from it on the card,
tests/test_torch_cuda.py).  Here it is held:

- streamed over chunks (``stream_filter``, ``StreamingSession``) against the
  benchmark's plain float64 reference, ``perfbench/configs/hgf_reference.py``,
  on seeded parameters and data drawn from the HGF's own generative model
  (``perfbench/inputs/hgf_generative.py``), by the reference's own numbers;
- against the JAX package's scan from the same state, at 1e-5 (the bar of
  tests/test_hgf.py);
- chunked against the whole series, by kernel and by scan: equal, bit for
  bit, since the state is float32 on both sides of a chunk's edge and every
  step runs the same float32 operations.

It also checks the state's refusals, the ``stream`` layer's spans and
counters, and that the benchmark's ``hgf.stream-64k`` cell loads and runs.
"""

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp
from cortex_tpu_torch.models import HGF, HGFState, HGFTrajectory
from cortex_tpu_torch.ops import kernels_hgf
from cortex_tpu_torch.parallel import StreamingSession, stream_filter
from cortex_tpu_torch.parallel import streaming
from cortex_tpu_torch.utils import spans, tree
from perfbench import faults, harness
from perfbench.tests import helpers

from cortex_tpu.models import HGF as JaxHGF
from cortex_tpu.models import HGFState as JaxHGFState

REPO = Path(__file__).resolve().parents[1]
R_, T_ = 64, 96
NONDEFAULT = dict(kappa=1.4, omega=-3.0, theta=0.2, pi_u=4.0, max_log_nu=8.0, min_pi2=0.05,
                  max_mu2_step=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference():
    return harness.load_module(REPO / "perfbench" / "configs" / "hgf_reference.py")


def _config(seed):
    """The ``hgf`` configuration with kappa, omega, theta and pi_u drawn
    from ``seed``."""
    config = json.loads((REPO / "perfbench" / "configs" / "hgf.json").read_text())
    rng = np.random.default_rng(seed)
    config.update(kappa=float(rng.uniform(0.5, 1.5)), omega=float(rng.uniform(-4.0, -1.0)),
                  theta=float(rng.uniform(0.01, 0.2)), pi_u=float(rng.uniform(2.0, 20.0)))
    return config


def _generative(config, seed, shape=(R_, T_)):
    inputs = harness.load_module(REPO / "perfbench" / "inputs" / "hgf_generative.py")
    gen = torch.Generator().manual_seed(seed)
    return inputs.make(config, {}, (1,) + shape, gen, "cpu")[0]


def _model(config):
    return HGF(**{name: config[name] for name in kernels_hgf.PARAMS})


def _chunks(u, width):
    return [u[:, i:i + width].contiguous() for i in range(0, u.shape[1], width)]


def _joined(final, outs):
    """The stream's results as the reference names them."""
    got = {f"{n}_final": v for n, v in zip(kernels_hgf.STATE, final)}
    for name, field in zip(kernels_hgf.ALL_TRACKS, HGFTrajectory._fields):
        got[name] = torch.cat([getattr(o, field) for o in outs], dim=1)
    return got


# Float32 against float64, by the reference's numbers.  Each step rounds some
# 40 float32 operations (2^-24 relative each); the filter forgets old errors
# but takes new ones, so each value stays within a few ulps of its own size:
# mu1 to ~1e-7 of |u| (up to ~420 on these walks), read in posterior s.d.
# (sqrt(pi1) < 8): mu_err up to ~1e-4; pi to a few 1e-7 relative; delta1, up
# to ~200 here, to ~1e-7 of that.  These seeds read mu_err <= 8.2e-5, pi_err
# <= 2.1e-6, delta1_err <= 4.5e-5; the bars sit ~10x above, and 50-600x below
# what the same recursion in bfloat16 reads (mu_err >= 0.42, pi_err >= 0.041,
# delta1_err >= 0.33), which each case checks.
TOL = {"mu_err": 8e-4, "pi_err": 2e-5, "delta1_err": 5e-4}


@pytest.mark.parametrize("width", [32, 37], ids=["chunks-of-32", "odd-chunks"])
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_fused_stream_matches_the_float64_reference(seed, width):
    config = _config(seed)
    u = _generative(config, seed)
    model, reference = _model(config), _reference()

    def step(state, chunk):
        return model.filter(chunk, state=state, method="fused")

    chunks = _chunks(u, width)
    final, outs = stream_filter(step, chunks, model.init_state((R_,), device="cpu"),
                                device="cpu")
    session = StreamingSession(step, model.init_state((R_,), device="cpu"), device="cpu")
    for chunk in chunks:
        session.push(chunk)
    session_final = session.flush()
    want = reference.reference(config, {"u": u})
    for got in (_joined(final, outs), _joined(session_final, session.outputs)):
        nums = reference.compare(config, got, want)
        assert set(nums) == set(TOL)
        for name, value in nums.items():
            assert value <= TOL[name], (name, value)
    # The bfloat16 control fails each bar.
    control = reference.compare(config, reference.reference(config, {"u": u}, "bfloat16"), want)
    assert all(control[name] > TOL[name] for name in TOL), control


# Every guard fires on 10 x normal observations (tests/test_torch_hgf_kernels.py).
GUARDS = dict(kappa=2.0, omega=-1.0, theta=0.5, pi_u=1000.0, max_log_nu=1.5, min_pi2=0.3,
              max_mu2_step=0.1)


def test_the_reference_keeps_the_ports_guards_and_counts_their_fires():
    """Where every guard fires, the port's fused stream still meets the
    reference's bars (the guards are the same departures from the paper),
    and the reference counts each guard's fires; on the configuration's own
    parameters and data the volatility clip never fires."""
    config = {**_config(0), **GUARDS}
    u = torch.from_numpy((10.0 * np.random.default_rng(4).normal(size=(R_, T_)))
                         .astype(np.float32))
    model, reference = _model(config), _reference()
    state, outs = model.init_state((R_,), device="cpu"), []
    for chunk in _chunks(u, 32):
        state, traj = model.filter(chunk, state=state, method="fused")
        outs.append(traj)
    want = reference.reference(config, {"u": u})
    nums = reference.compare(config, _joined(state, outs), want)
    assert nums["mu_err"] <= TOL["mu_err"] and nums["pi_err"] <= TOL["pi_err"], nums
    # delta1 reaches ~3,000 here (pi_u = 1000): its bar is relative, ~17 ulps.
    assert nums["delta1_err"] <= 1e-6 * float(want["delta1"].abs().max()), nums
    fires = reference.guard_fires(u, config)
    assert fires["steps"] == R_ * T_
    assert all(fires[name] > 0 for name in ("log_nu", "pi2", "mu2_step")), fires
    config = json.loads((REPO / "perfbench" / "configs" / "hgf.json").read_text())
    assert reference.guard_fires(_generative(config, 5), config)["log_nu"] == 0


def _state(seed, R):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=R).astype(np.float32), (0.5 + 3 * rng.random(R)).astype(np.float32),
            rng.normal(size=R).astype(np.float32), (0.5 + 3 * rng.random(R)).astype(np.float32)]


@pytest.mark.parametrize("params", [{}, NONDEFAULT], ids=["defaults", "nondefault"])
def test_the_plain_twin_from_a_state_matches_the_jax_scan(params):
    rng = np.random.default_rng(5)
    u = (0.3 * rng.normal(size=(9, 40)).cumsum(-1)).astype(np.float32)
    state = _state(6, 9)
    jax_final, jax_traj = JaxHGF(**params).filter(jnp.asarray(u),
                                                  state=JaxHGFState(*map(jnp.asarray, state)))
    finals, values = kernels_hgf.hgf_filter_fused(
        torch.from_numpy(u), **params, state=tuple(map(torch.from_numpy, state)))
    model_final, model_traj = HGF(**params).filter(
        torch.from_numpy(u), state=HGFState(*map(torch.from_numpy, state)), method="fused")
    for got in (zip(finals, jax_final), zip(model_final, jax_final),
                zip(values, jax_traj), zip(model_traj, jax_traj)):
        for g, w in got:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_chunked_fused_equals_the_whole_series_by_kernel_and_by_scan():
    config = _config(11)
    u = _generative(config, 11)
    model = _model(config)
    state = model.init_state((R_,), device="cpu")
    outs = []
    for chunk in _chunks(u, 32):
        state, traj = model.filter(chunk, state=state, method="fused")
        outs.append(traj)
    for whole in (model.filter(u, method="fused"), model.filter(u, method="scan")):
        assert all(torch.equal(g, w) for g, w in zip(state, whole[0]))
        for field in HGFTrajectory._fields:
            joined = torch.cat([getattr(o, field) for o in outs], dim=1)
            assert torch.equal(joined, getattr(whole[1], field)), field
    # From a state that is not the zero one: the second half alone, from the
    # first half's final state, gives the whole series' second half.
    half, _ = model.filter(u[:, :48], method="fused", tracks=())
    rest, traj = model.filter(u[:, 48:], state=half, method="fused", tracks=("mu2",))
    whole, whole_traj = model.filter(u, method="fused", tracks=("mu2",))
    assert all(torch.equal(g, w) for g, w in zip(rest, whole))
    assert torch.equal(traj.mu2, whole_traj.mu2[:, 48:])


def _bad_states():
    ok = HGF().init_state((5,), device="cpu")
    return {
        "shape": (ok._replace(pi1=torch.ones(6)), "of shape \\(5,\\), got \\(6,\\)"),
        "dtype": (ok._replace(mu2=torch.zeros(5, dtype=torch.float64)),
                  "float32, got torch.float64"),
        "grad": (ok._replace(mu1=torch.zeros(5, requires_grad=True)), "requires grad"),
        "count": (tuple(ok)[:3], "got 3 entries"),
        "device": (ok._replace(pi2=torch.ones(5, device="meta")), "must be on cpu, got meta"),
    }


@pytest.mark.parametrize("case", sorted(_bad_states()))
def test_a_state_the_kernel_cannot_take_raises_value_error(case):
    state, match = _bad_states()[case]
    u = torch.zeros(5, 7)
    with pytest.raises(ValueError, match=match):
        kernels_hgf.hgf_filter_fused(u, state=state)
    if case != "count":  # HGFState needs four entries
        with pytest.raises(ValueError, match=match):
            HGF().filter(u, state=state, method="fused")


def test_the_operator_takes_all_four_state_tensors_or_none():
    u, ones = torch.zeros(4, 3), torch.ones(4)
    op = kernels_hgf._HGF_FILTER
    with pytest.raises(ValueError, match="all four"):
        op(u, 1.0, -2.0, 0.05, 10.0, 20.0, 0.01, 5.0, [0], False, ones, ones)
    finals, _ = op(u, 1.0, -2.0, 0.05, 10.0, 20.0, 0.01, 5.0, [0], False, ones, ones, ones, ones)
    want, _ = kernels_hgf.hgf_filter_fused(u, state=(ones, ones, ones, ones), tracks=("mu1",))
    assert all(torch.equal(g, w) for g, w in zip(finals, want))
    # The cost counts the state's 16 bytes a replica read.
    args = (u, 1.0, -2.0, 0.05, 10.0, 20.0, 0.01, 5.0, [0], False)
    assert (kernels_hgf._cost(*args, ones, ones, ones, ones)[1]
            == kernels_hgf._cost(*args)[1] + 16.0 * 4)


def test_the_stream_layer_records_its_spans_and_counts_its_chunks(monkeypatch):
    monkeypatch.setattr(tree, "DEFAULT_DEVICE", "cpu")
    u = _generative(_config(1), 1, (8, 48))
    model = HGF()

    def step(state, chunk):
        return model.filter(chunk, state=state, method="fused", tracks=())

    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            stream_filter(step, _chunks(u, 16), model.init_state((8,), device="cpu"),
                          device="cpu")
            session = StreamingSession(step, model.init_state((8,), device="cpu"), device="cpu")
            session.push(u[:, :16].numpy())
            session.flush()
        records = spans.calls()
    finally:
        spans.reset()
    assert [r.name for r in records] == ["stream.filter"] * 3
    stream, push, flush = records
    assert stream.counts["stream.chunks"] == 3 and push.counts["stream.chunks"] == 1
    assert stream.counts["stream.bytes"] == 3 * 8 * 16 * 4
    assert "stream.chunks" not in flush.counts
    for record in (stream, flush):  # the model's work on a chunk, inside the stream's
        assert {"stream", "model", "boundary"} <= set(record.layers)
    assert math.isclose(sum(stream.layers.values()), stream.end_ns - stream.start_ns)


def test_a_staged_upload_counts_as_a_copy_to_the_device():
    """The stager's copy goes through ``spans.h2d``: on a host without a card
    the meta device stands in for the card (no side stream), and what is
    already on the device is not copied."""
    chunk = torch.zeros(4, 5)
    before = spans.counts()
    staged, done = streaming._Stager("meta").put(chunk)
    after = spans.counts()
    assert staged.device.type == "meta" and done is None
    assert after["copy.h2d.calls"] == before["copy.h2d.calls"] + 1
    assert after["copy.h2d.bytes"] == before["copy.h2d.bytes"] + 80
    assert after["stream.chunks"] == before["stream.chunks"] + 1
    same, _ = streaming._Stager("cpu").put(chunk)
    assert same is chunk and spans.counts()["copy.h2d.calls"] == after["copy.h2d.calls"]


def test_the_stream_cell_loads_and_runs_on_the_cpu(tmp_path, monkeypatch):
    """``hgf.stream-64k``'s files load by name; the entry, at a tiny size on
    the CPU, is judged correct, and the answer and half faults are caught.
    The test process holds JAX (this file's parity tests), which a
    benchmark process refuses: that gate is left out here."""
    monkeypatch.setattr(harness, "banned_modules", lambda: [])

    cell = harness.find_cell(REPO, "hgf.stream-64k")
    assert cell.chips == 1 and cell.config["name"] == "hgf"
    assert {"k4_roofline", "h2d_link_share", "stream_us_per_call"} <= {
        m["name"] for m in cell.metrics}
    tiny = {"tiny-stream": dict(cell.traffic, replicas=16, ring_batches=2, judged_calls=2)}
    root = helpers.make_root(tmp_path, cells={"hgf.tiny-stream": ("hgf", "tiny-stream")},
                             traffic=tiny)
    out = harness.run_cell(harness.find_cell(root, "hgf.tiny-stream"), 2**31 + 3, 0.2, False,
                           "cpu", time.perf_counter())
    assert out.result["correct"], out.checks
    for fault in (faults.answer, faults.half):
        broken = harness.run_cell(harness.find_cell(root, "hgf.tiny-stream"), 2**31 + 3, 0.2,
                                  False, "cpu", time.perf_counter(), wrap=fault)
        assert not broken.result["correct"], (fault.__name__, broken.checks)


def _run(trace):
    cell = harness.find_cell(REPO, "hgf.stream-64k")
    return harness.Run(cell=cell, entry=None, setup_s=1.0, window=harness.Part(), trace=trace)


@pytest.mark.parametrize("metric", ["k4_roofline", "h2d_link_share", "stream_us_per_call"])
def test_the_stream_cells_metrics_read_their_records_or_nothing(metric, monkeypatch):
    """The cell's three readers: K4's share of its roofline from its kernel
    records, the link's share from the ``Memcpy HtoD`` records, the stream
    layer's self time from the span records; each reads nothing (``None``)
    where its records are missing, as in a parent without the stream layer."""
    from perfbench import devtrace

    reader = harness.load_module(REPO / "perfbench" / "metrics" / f"{metric}.py")
    R, chunk = 65536, 32
    trace = devtrace.Trace(
        window_s=1.0, busy_s=0.5, calls=2,
        kernels=[("void (anonymous namespace)::hgf_filter_kernel<float>(...)", 40e-6)] * 16,
        copies=[("Memcpy HtoD (Pinned -> Device)", 0.2e-3)] * 16)
    records = [spans.CallRecord(i, "stream.filter", 0, 100_000,
                                {"stream": 30_000, "model": 70_000}, {"stream.chunks": 8})
               for i in range(2)]
    monkeypatch.setattr(spans, "calls", lambda: records)
    want = {"k4_roofline": 100.0 * (52_428_800 / 3.35e12) / 40e-6,
            "h2d_link_share": 100.0 * (4 * R * 256 / 64e9) / (8 * 0.2e-3),
            "stream_us_per_call": 30.0}[metric]
    assert (4 * R * chunk + 16 * R + 16 * R + 5 * 4 * R * chunk) == 52_428_800
    assert reader.read(_run(trace)) == pytest.approx(want)
    monkeypatch.setattr(spans, "calls", lambda: [r._replace(layers={"model": 100_000})
                                                 for r in records])
    empty = devtrace.Trace(window_s=1.0, busy_s=0.5, calls=2)
    assert reader.read(_run(empty)) is None
