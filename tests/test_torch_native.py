"""Port parity: the native C++ signal core (``cortex_tpu_torch.native``)
against the port's Python signal core.

``tests/test_native.py``'s cases on the port: the same C++ source (a copy of
the JAX package's, held to it line by line but for comments), built into the
package's build directory, and bound to the port's ``core``; randomized op
sequences give the same observable state as the Python ``Signal``, the
unchanged ``InferenceEngine`` runs on native signals, and the native scan
matches the Python scanner.  The dense fan-out runs on both cores with equal
results; its timing (native faster than Python) is held on the card's host
by ``chip_smoke.py``, not under the test runner's parallel workers.
"""

import pathlib
import random as pyrandom
import re
from typing import NamedTuple

import pytest
import torch

from cortex_tpu_torch import (
    BipartiteFactorGraph,
    Factor,
    InferenceEngine,
    Signal,
    UNDEF,
)
from cortex_tpu_torch import InferenceRequestProcessor
from cortex_tpu_torch.native import NativeSignalEngine, bindings

REPO = pathlib.Path(__file__).resolve().parent.parent


class Beta(NamedTuple):
    a: float
    b: float


class BetaBernoulliProcessor(InferenceRequestProcessor):
    """tests/test_inference_engine.py's conjugate rules, on the port's core."""

    def compute_message_to_variable(self, engine, variant, signal, dependencies):
        factor = engine.get_factor(variant.factor_id)
        if factor.get_functional_form() == "bernoulli":
            r = 1 if dependencies[0].get_value() else 0
            return Beta(1 + r, 2 - r)
        raise RuntimeError("Should not be invoked")

    def compute_individual_marginal(self, engine, variant, signal, dependencies):
        answer = dependencies[0].get_value()
        for d in dependencies[1:]:
            nxt = d.get_value()
            answer = Beta(answer.a + nxt.a - 1, answer.b + nxt.b - 1)
        return answer

    compute_product_of_messages = compute_individual_marginal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in the other port test files (nothing here
    runs torch kernels; the runner's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_source_is_the_jax_packages():
    """The C++ source equals the JAX package's but for its comments, and the
    library lands in the package's build directory, named by its hash."""
    def code(path):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        return [line.rstrip() for line in text.splitlines() if line.strip()]

    assert code(REPO / "cortex_tpu_torch/native/signal_core.cpp") == code(
        REPO / "cortex_tpu/native/signal_core.cpp")
    from cortex_tpu_torch import _build

    path = bindings.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libsignal_core_")
    bindings.load_native_lib()
    assert path.exists()


@pytest.fixture(scope="module")
def ns():
    return NativeSignalEngine()


def test_basic_lifecycle(ns):
    s = ns.create_signal()
    assert not s.is_computed()
    assert not s.is_pending()
    s.set_value(42)
    assert s.is_computed()
    assert s.get_value() == 42


def test_pending_semantics_match_python_basic(ns):
    # Mirror of the core weak/strong scenarios.
    weak_dep = ns.create_signal(1)
    strong_dep = ns.create_signal(2)
    derived = ns.create_signal()
    derived.add_dependency(weak_dep, weak=True)
    derived.add_dependency(strong_dep)
    assert derived.is_pending()
    derived.set_value(10)
    assert not derived.is_pending()
    strong_dep.set_value(3)
    assert derived.is_pending()
    derived.set_value(11)
    weak_dep.set_value(4)
    assert not derived.is_pending()
    strong_dep.set_value(5)
    assert derived.is_pending()


def test_duplicate_dependency_caveat_parity(ns):
    s1 = ns.create_signal()
    s2 = ns.create_signal()
    s1.add_dependency(s2)
    s1.add_dependency(s2)
    assert len(s1.get_dependencies()) == 2
    assert len(s2.get_listeners()) == 2
    s2.set_value(1)
    # Only the first duplicate slot is notified -> not pending (matches the
    # documented reference hazard).
    assert not s1.is_pending()


def test_self_dependency_noop(ns):
    s = ns.create_signal()
    s.add_dependency(s)
    assert s.get_dependencies() == []
    assert not s.is_pending()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_differential_random_ops(seed):
    """Randomized op sequences produce identical observable state on the
    Python and native cores."""
    rng = pyrandom.Random(seed)
    ns = NativeSignalEngine()
    py_signals = []
    nat_signals = []

    def new_signal(with_value):
        v = rng.randint(0, 100) if with_value else UNDEF
        p = Signal(v)
        n = ns.create_signal(v)
        py_signals.append(p)
        nat_signals.append(n)

    for _ in range(5):
        new_signal(rng.random() < 0.5)

    for opi in range(300):
        op = rng.random()
        if op < 0.15 and len(py_signals) < 40:
            new_signal(rng.random() < 0.3)
        elif op < 0.55 and len(py_signals) >= 2:
            a, b = rng.randrange(len(py_signals)), rng.randrange(len(py_signals))
            kwargs = dict(
                weak=rng.random() < 0.3,
                listen=rng.random() < 0.8,
                check_computed=rng.random() < 0.8,
                intermediate=rng.random() < 0.3,
            )
            py_signals[a].add_dependency(py_signals[b], **kwargs)
            nat_signals[a].add_dependency(nat_signals[b], **kwargs)
        else:
            i = rng.randrange(len(py_signals))
            v = rng.randint(0, 100)
            py_signals[i].set_value(v)
            nat_signals[i].set_value(v)

        # Observable state must match exactly after every operation.
        # (Order matters: is_pending caches lazily on both sides.)
        for j, (p, n) in enumerate(zip(py_signals, nat_signals)):
            assert p.is_computed() == n.is_computed(), (seed, opi, j)
            assert p.is_pending() == n.is_pending(), (seed, opi, j)


def test_process_dependencies_parity(ns):
    source = ns.create_signal()
    intermediate = ns.create_signal()
    derived = ns.create_signal()
    intermediate.add_dependency(source)
    derived.add_dependency(intermediate, intermediate=True)

    attempted = []

    def cb(dep):
        attempted.append(dep)
        return dep is not intermediate

    processed = derived.process_dependencies(cb, retry=True)
    assert attempted == [intermediate, source, intermediate]
    assert processed


def test_full_dynamic_inference_on_native_signals():
    """The unchanged InferenceEngine runs on native signals: Beta-Bernoulli
    exact conjugate posterior (mirrors test_inference_engine)."""
    ns = NativeSignalEngine()
    n = 50
    g = BipartiteFactorGraph()
    p = g.add_variable(ns.variable("p"))
    o, f = [], []
    for i in range(n):
        oi = g.add_variable(ns.variable("o", (i,)))
        fi = g.add_factor(Factor(functional_form="bernoulli"))
        o.append(oi)
        f.append(fi)
        g.add_edge(p, fi, ns.connection("out"))
        g.add_edge(oi, fi, ns.connection("out"))

    engine = InferenceEngine(
        model_engine=g, inference_request_processor=BetaBernoulliProcessor()
    )
    rng = pyrandom.Random(7)
    data = [rng.random() < 0.6 for _ in range(n)]
    for i in range(n):
        engine.get_message_to_factor(o[i], f[i]).set_value(data[i])
    engine.update_marginals(p)
    posterior = engine.get_variable_marginal(p).get_value()
    assert posterior.a == pytest.approx(1.0 + sum(data))
    assert posterior.b == pytest.approx(1.0 + n - sum(data))


def test_native_scan_pending_matches_python_scanner():
    from cortex_tpu_torch import scan_inference_request

    ns = NativeSignalEngine()
    g = BipartiteFactorGraph()
    p = g.add_variable(ns.variable("p"))
    o, f = [], []
    for i in range(10):
        oi = g.add_variable(ns.variable("o", (i,)))
        fi = g.add_factor(Factor(functional_form="bern"))
        o.append(oi)
        f.append(fi)
        g.add_edge(p, fi, ns.connection("out"))
        g.add_edge(oi, fi, ns.connection("out"))
    engine = InferenceEngine(model_engine=g)
    for i in range(10):
        engine.get_message_to_factor(o[i], f[i]).set_value(1.0)

    request = engine.request_inference_for(p)
    python_scan = scan_inference_request(request)

    # Re-request (scanning consumed pending state), then native scan.
    request = engine.request_inference_for(p)
    native_scan = ns.scan_pending(engine.get_variable_marginal(p))
    assert [id(s) for s in native_scan] == [id(s) for s in python_scan]


def test_native_fanout_matches_python():
    """test_native.py's dense fan-out (here 100 x 100): every sink pending on
    both cores (chip_smoke.py times it at 300 x 300)."""
    n = 100

    def build(create):
        sources = [create() for _ in range(n)]
        sinks = [create() for _ in range(n)]
        for snk in sinks:
            for src in sources:
                snk.add_dependency(src)
        return sources, sinks

    def drive(sources, sinks):
        for s in sources:
            s.set_value(1)
        return sum(1 for s in sinks if s.is_pending())

    ns = NativeSignalEngine()
    assert drive(*build(ns.create_signal)) == drive(*build(Signal)) == n


def test_bulk_add_dependencies_matches_singles():
    ns = NativeSignalEngine()
    sources = [ns.create_signal() for _ in range(20)]
    bulk = ns.create_signal()
    single = ns.create_signal()
    bulk.add_dependencies(sources, weak=False)
    for s in sources:
        single.add_dependency(s)
    for i, s in enumerate(sources):
        s.set_value(i)
    assert bulk.is_pending() == single.is_pending() == True
    assert len(bulk.get_dependencies()) == 20
