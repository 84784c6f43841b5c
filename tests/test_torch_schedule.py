"""Port parity: schedule extraction and chain lowering (``cortex_tpu_torch.compile``)
against ``cortex_tpu.compile``.

Both are pure Python, so the checks are exact: the same graph, built in each
package, gives identical ``extract_schedule(...).summary()`` and
``lower_schedule(...).summary()``; cycle detection, skipped signals and the
weak-deadlock warning behave as in tests/test_compile.py on both packages.

The lowering lists the independent groups of one re-phased phase in an order
that can change from one build of the same graph to the next, in either
package (it follows ``id()``-keyed sets), so lowered plans are compared with
each phase's groups sorted; the values do not depend on that order.
"""

import pytest
import torch

from test_torch_core import GRAPHS, PKGS, build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canonical(plan_summary):
    """A plan summary with each phase's groups in sorted order."""
    lines = []
    for line in plan_summary.splitlines():
        head, sep, groups = line.partition("phase: ")
        lines.append(head + sep + ", ".join(sorted(groups.split(", "))) if sep else line)
    return "\n".join(lines)


def _summaries(pkg, graph):
    engine, targets, refine_key = build(pkg, graph)
    sched = pkg.compile.extract_schedule(engine, targets, refine_key=refine_key)
    plans = [pkg.compile.lower_schedule(sched, emit_all=e) for e in (False, True)]
    return (sched.summary(), len(sched.sources), len(sched.initials), sched.num_steps,
            [None if p is None else _canonical(p.summary()) for p in plans])


@pytest.mark.parametrize("graph", GRAPHS)
def test_schedule_and_lowering_summaries_match(graph):
    got = _summaries(PKGS["torch"], graph)
    assert got == _summaries(PKGS["jax"], graph)
    assert got[3] > 0


def test_lowering_phase_order_is_the_only_difference_between_builds():
    """Two builds of the structured graph in the JAX package: equal once each
    phase's groups are sorted."""
    plans = [_summaries(PKGS["jax"], "structured_6")[4] for _ in range(4)]
    assert all(p == plans[0] for p in plans)


def test_chain_lowers_to_one_scan_in_the_port():
    engine, x, _, _ = PKGS["torch"].models.make_chain_graph(32)
    plan = PKGS["torch"].compile.lower_schedule(
        PKGS["torch"].compile.extract_schedule(engine, x))
    assert [s.length for s in plan.scan_segments] == [30]


def _two_marginals(pkg):
    c = pkg.core
    g = c.BipartiteFactorGraph()
    v = g.add_variable(c.Variable(name="v"))
    engine = c.InferenceEngine(model_engine=g, resolve_dependencies=False)
    a, b = c.create_inference_signal(), c.create_inference_signal()
    a.set_variant(c.variants.IndividualMarginal(v))
    b.set_variant(c.variants.IndividualMarginal(v))
    return engine, v, a, b


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_schedule_cycle_detection(pkg):
    pkg = PKGS[pkg]
    engine, v, a, b = _two_marginals(pkg)
    a.add_dependency(b, intermediate=True)
    b.add_dependency(a, intermediate=True)
    engine.get_variable(v).marginal.add_dependency(a, intermediate=True)
    with pytest.raises(ValueError, match="cycle"):
        pkg.compile.extract_schedule(engine, [v])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_schedule_skips_never_computable_signals(pkg):
    pkg = PKGS[pkg]
    engine, v, a, b = _two_marginals(pkg)
    a.add_dependency(b)
    b.add_dependency(a)
    engine.get_variable(v).marginal.add_dependency(a)
    with pytest.warns(UserWarning, match="silently never run"):
        sched = pkg.compile.extract_schedule(engine, [v])
    assert sched.num_steps == 0
    assert len(sched.skipped) >= 2


def _deadlock(pkg):
    c = pkg.core
    g = c.BipartiteFactorGraph()
    v = g.add_variable(c.Variable(name="v"))
    w = g.add_variable(c.Variable(name="w"))
    engine = c.InferenceEngine(model_engine=g, resolve_dependencies=False)
    mv = engine.get_variable(v).marginal
    mw = engine.get_variable(w).marginal
    mv.add_dependency(mw, weak=True, intermediate=True)
    mw.add_dependency(mv, weak=True, intermediate=True)
    with pytest.warns(UserWarning, match="silently never run") as record:
        sched = pkg.compile.extract_schedule(engine, [v, w])
    assert {id(s) for s in sched.skipped} == {id(mv), id(mw)}
    return ([str(r.message) for r in record],
            [(wn.description, sorted(wn.context)) for wn in engine.get_warnings()])


def test_weak_deadlock_warns_alike_in_both_packages():
    got = _deadlock(PKGS["torch"])
    assert got == _deadlock(PKGS["jax"])
    assert any("silently never run" in d for d, _ in got[1])
