"""Port parity: the reactive core (``cortex_tpu_torch.core``) against ``cortex_tpu.core``.

Both packages hold their own copy of the pure-Python core, so these are exact
checks, with no tolerance:

- every case of ``tests/test_signal.py`` runs on both packages;
- the resolvers wire the same dependency DAG in both packages (variant types
  and ids, dependency order, weak and intermediate flags) on a Beta-Bernoulli
  star, the BP chain, the mean-field and structured SSMs, and random trees;
- the dynamic engine's ``update_marginals`` on the chain gives equal
  marginals and equal warnings.

It also holds the graph constructors that the other ``test_torch_*`` files of
the compiled path share: each builds the same graph in either package.
"""

import ast
import dataclasses
import pathlib
import random as pyrandom
import types

import numpy as np
import pytest
import torch

import cortex_tpu_torch
import cortex_tpu_torch.compile
import cortex_tpu_torch.dists
import cortex_tpu_torch.models

import cortex_tpu
import cortex_tpu.compile
import cortex_tpu.dists
import cortex_tpu.models


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

HERE = pathlib.Path(__file__).parent

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", core=cortex_tpu, compile=cortex_tpu.compile, dists=cortex_tpu.dists,
        models=cortex_tpu.models, kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", core=cortex_tpu_torch, compile=cortex_tpu_torch.compile,
        dists=cortex_tpu_torch.dists, models=cortex_tpu_torch.models, kw={"device": "cpu"},
    ),
}


# -- graph constructors shared by the compiled-path tests --------------------


def make_beta_bernoulli_graph(pkg, n):
    """Beta-Bernoulli star: ``p`` joined to n observations by ``bernoulli``
    factors (as tests/test_compile.py builds it)."""
    c = pkg.core
    g = c.BipartiteFactorGraph()
    p = g.add_variable(c.Variable(name="p"))
    o, f = [], []
    for i in range(n):
        oi = g.add_variable(c.Variable(name="o", index=(i,)))
        fi = g.add_factor(c.Factor(functional_form="bernoulli"))
        o.append(oi)
        f.append(fi)
        g.add_edge(p, fi, c.Connection(label="out"))
        g.add_edge(oi, fi, c.Connection(label="out"))
    return c.InferenceEngine(model_engine=g), p, o, f


def beta_bernoulli_rules(pkg):
    class BetaBernoulliBatched(pkg.compile.BatchedProcessor):
        def compute_message_to_variable(self, engine, variants, dep_values):
            y = dep_values[0]
            return pkg.dists.Beta(1.0 + y, 2.0 - y)

    return BetaBernoulliBatched()


def random_tree_model(pkg, seed):
    """A random tree of latents with 1-6 observed leaves each (as
    tests/test_fuzz_equivalence.py builds it); returns ``(engine, latents,
    observed)``."""
    c = pkg.core
    rng = pyrandom.Random(seed)
    n_latent = rng.randint(2, 9)
    g = c.BipartiteFactorGraph()
    latents = [g.add_variable(c.Variable(name="z", index=(i,))) for i in range(n_latent)]
    observed = []
    for i in range(1, n_latent):
        parent = latents[rng.randrange(i)]
        f = g.add_factor(c.Factor(functional_form="link"))
        g.add_edge(parent, f, c.Connection(label="out"))
        g.add_edge(latents[i], f, c.Connection(label="in"))
    for i in range(n_latent):
        for _ in range(rng.randint(1, 6)):
            o = g.add_variable(c.Variable(name="y", index=(len(observed),)))
            f = g.add_factor(c.Factor(functional_form="obs"))
            g.add_edge(latents[i], f, c.Connection(label="out"))
            g.add_edge(o, f, c.Connection(label="out"))
            observed.append((o, f))
    return c.InferenceEngine(model_engine=g), latents, observed


def tree_rules(pkg):
    """Sum-product on the random trees: 'obs' lifts y to N(y, 1), 'link'
    adds unit variance."""

    class TreeBatched(pkg.compile.BatchedProcessor):
        def compute_message_to_variable(self, engine, variants, dep_values):
            form = engine.get_factor(variants[0].factor_id).functional_form
            v = dep_values[0]
            if form == "obs":
                return pkg.dists.from_mean_variance(v, 1.0 + 0.0 * v)
            return pkg.dists.from_mean_variance(v.mean, v.variance + 1.0)

    return TreeBatched()


GRAPHS = ["beta_bernoulli_5", "chain_12", "mean_field_6", "structured_6",
          "tree_0", "tree_1", "tree_2"]


def build(pkg, graph):
    """``(engine, targets, refine_key)`` of one of :data:`GRAPHS`."""
    if graph == "beta_bernoulli_5":
        engine, p, _, _ = make_beta_bernoulli_graph(pkg, 5)
        return engine, [p], None
    if graph == "chain_12":
        engine, x, _, _ = pkg.models.make_chain_graph(12)
        return engine, x, None
    if graph in ("mean_field_6", "structured_6"):
        make = (pkg.models.make_mean_field_ssm_graph if graph == "mean_field_6"
                else pkg.models.make_structured_ssm_graph)
        engine, x, _, ss, obs = make(6, [0.0] * 6, **pkg.kw)
        return engine, [ss, obs] + x, pkg.compile.dep_role_key
    engine, latents, _ = random_tree_model(pkg, int(graph.split("_")[1]))
    return engine, latents, None


def wiring(engine, targets):
    """The dependency DAG behind the targets' marginals, depth first:
    per signal its variant (type and fields), its dependencies (by visit
    index) and each dependency's weak and intermediate flags."""
    index, nodes = {}, []

    def visit(sig):
        if id(sig) in index:
            return index[id(sig)]
        index[id(sig)] = len(nodes)
        nodes.append(None)
        deps = sig.get_dependencies()
        children = tuple(visit(d) for d in deps)
        flags = tuple((sig.dep_is_weak(i), sig.dep_is_intermediate(i)) for i in range(len(deps)))
        v = sig.variant
        fields = dataclasses.astuple(v) if dataclasses.is_dataclass(v) else repr(v)
        nodes[index[id(sig)]] = (type(v).__name__, fields, children, flags)
        return index[id(sig)]

    for t in targets:
        visit(engine.get_variable_marginal(t))
    return nodes


# -- tests/test_signal.py on both packages -----------------------------------


def _signal_cases(pkg_name):
    """The test functions of tests/test_signal.py with ``cortex_tpu``'s
    names swapped for the package's, each with its parameter sets."""
    source = (HERE / "test_signal.py").read_text()
    if pkg_name == "torch":
        source = source.replace("from cortex_tpu import", "from cortex_tpu_torch import")
    module = types.ModuleType(f"signal_cases_{pkg_name}")
    exec(compile(source, str(HERE / "test_signal.py"), "exec"), module.__dict__)
    cases = {}
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        params = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argname, values = mark.args
            params = [dict(p, **{argname: v}) for p in params for v in values]
        for p in params:
            suffix = "-".join(f"{k}={v}" for k, v in sorted(p.items()))
            cases[name + (f"[{suffix}]" if suffix else "")] = (fn, p)
    return cases


_SIGNAL_CASES = {pkg: _signal_cases(pkg) for pkg in PKGS}


def test_signal_cases_are_the_same_in_both_packages():
    assert sorted(_SIGNAL_CASES["jax"]) == sorted(_SIGNAL_CASES["torch"])
    assert len(_SIGNAL_CASES["torch"]) > 40


@pytest.mark.parametrize("case", sorted(_SIGNAL_CASES["torch"]))
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_signal_case_runs_on_both_packages(pkg, case):
    fn, params = _SIGNAL_CASES[pkg][case]
    fn(**params)


def test_signal_cases_use_the_ports_signal():
    fn, _ = _SIGNAL_CASES["torch"]["test_basic_signal_operations"]
    assert fn.__globals__["Signal"] is cortex_tpu_torch.Signal
    assert cortex_tpu_torch.Signal.__module__ == "cortex_tpu_torch.core.signal"


# -- resolvers ----------------------------------------------------------------


@pytest.mark.parametrize("graph", GRAPHS)
def test_resolvers_wire_the_same_dependencies(graph):
    got = wiring(*build(PKGS["torch"], graph)[:2])
    want = wiring(*build(PKGS["jax"], graph)[:2])
    assert got == want
    assert len(got) > 5


# -- the dynamic engine ---------------------------------------------------------


def _dynamic_chain(pkg, data, isolated):
    """The chain SSM (as ``make_chain_graph`` builds it) on the dynamic
    engine, with an ``isolated`` variable that no factor touches (the
    resolver warns of it) or without; returns the marginals and warnings."""
    c, n = pkg.core, len(data)
    g = c.BipartiteFactorGraph()
    x = [g.add_variable(c.Variable(name="x", index=(i,))) for i in range(n)]
    y = [g.add_variable(c.Variable(name="y", index=(i,))) for i in range(n)]
    if isolated:
        g.add_variable(c.Variable(name="w"))
    likelihood = [g.add_factor(c.Factor(functional_form="likelihood")) for _ in range(n)]
    transition = [g.add_factor(c.Factor(functional_form="transition")) for _ in range(n - 1)]
    for i in range(n):
        g.add_edge(y[i], likelihood[i], c.Connection(label="out"))
        g.add_edge(x[i], likelihood[i], c.Connection(label="out"))
    for i in range(n - 1):
        g.add_edge(x[i], transition[i], c.Connection(label="out"))
        g.add_edge(x[i + 1], transition[i], c.Connection(label="in"))
    engine = c.InferenceEngine(
        model_engine=g, inference_request_processor=pkg.models.LGSSMChainDynamic())
    for i, v in enumerate(data):
        engine.get_message_to_factor(y[i], likelihood[i]).set_value(float(v))
    engine.update_marginals(x)
    marginals = [engine.get_variable_marginal(v).get_value() for v in x]
    warnings = [(w.description, w.context) for w in engine.get_warnings()]
    return [(m.mean, m.variance) for m in marginals], warnings


@pytest.mark.parametrize("isolated", [False, True])
def test_dynamic_engine_update_marginals_matches(isolated):
    data = np.random.default_rng(4).normal(size=12).cumsum()
    got = _dynamic_chain(PKGS["torch"], data, isolated)
    want = _dynamic_chain(PKGS["jax"], data, isolated)
    assert got == want
    assert len(got[1]) == int(isolated)


def test_core_modules_are_copies_of_the_jax_packages():
    """The pure-Python layers are held to their originals line by line:
    they differ only in docstrings and comments."""
    def code_lines(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body.pop(0)  # the docstring
        return ast.dump(tree)

    root = HERE.parent
    for rel in ("utils/__init__.py", "core/signal.py", "core/variants.py",
                "core/model_engine.py", "core/graph.py", "core/resolvers.py",
                "core/engine.py", "core/__init__.py", "compile/schedule.py",
                "compile/lowering.py", "viz/dot.py", "viz/__init__.py"):
        assert code_lines(root / "cortex_tpu_torch" / rel) == code_lines(
            root / "cortex_tpu" / rel), rel


# The Pallas kernels' modules and their counterparts in the port, with the
# public names that the port renamed (JAX's "pallas" method is "fused").
PALLAS_COUNTERPARTS = {
    "ops/pallas_kernels.py": "ops/kernels.py",
    "ops/pallas_hmm.py": "ops/kernels_hmm.py",
    "ops/pallas_hgf.py": "ops/kernels_hgf.py",
}
RENAMED = {
    "lgssm_smooth_pallas": "lgssm_smooth_fused",
    "hmm_forward_backward_pallas": "hmm_forward_backward_fused",
    "hmm_forward_backward_counts_pallas": "hmm_forward_backward_counts_fused",
    "HMMPallasPosterior": "HMMFusedPosterior",
    "HMMPallasCounts": "HMMFusedCounts",
    "hgf_filter_pallas": "hgf_filter_fused",
}


def _public_names(module):
    """``__all__``, else the names a module defines that do not start with
    an underscore (not those it imports)."""
    import inspect

    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {name for name, obj in vars(module).items()
            if not name.startswith("_") and not inspect.ismodule(obj)
            and getattr(obj, "__module__", module.__name__) == module.__name__}


def test_every_jax_module_has_its_counterpart_in_the_port():
    """Each module of cortex_tpu has a module at the same path in
    cortex_tpu_torch with each of its public names (the Pallas files'
    counterparts are ops/kernels*.py, under the names in RENAMED)."""
    import importlib

    root = HERE.parent
    missing = {}
    for src in sorted((root / "cortex_tpu").rglob("*.py")):
        rel = src.relative_to(root / "cortex_tpu").as_posix()
        port_rel = PALLAS_COUNTERPARTS.get(rel, rel)
        if not (root / "cortex_tpu_torch" / port_rel).exists():
            missing[rel] = "no module"
            continue
        names = [p for p in rel.removesuffix(".py").split("/") if p != "__init__"]
        port_names = [p for p in port_rel.removesuffix(".py").split("/") if p != "__init__"]
        jax_mod = importlib.import_module(".".join(["cortex_tpu", *names]))
        port_mod = importlib.import_module(".".join(["cortex_tpu_torch", *port_names]))
        lacking = {RENAMED.get(n, n) for n in _public_names(jax_mod)} - _public_names(port_mod)
        if lacking:
            missing[rel] = sorted(lacking)
    assert not missing, missing
