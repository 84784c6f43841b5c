"""Port parity: the batched executor and tracing (``cortex_tpu_torch.compile``) and
the compiled-path models against ``cortex_tpu``.

The same numpy inputs, made from a seed, go through the JAX executor (called
eagerly on the CPU) and the port's.  Tolerances:

- ``smart_stack``, ``product_reduce``, the Beta-Bernoulli closed form and
  replica batching: rtol 1e-6 (the bar of tests/test_compile.py);
- the BP chain at T = 12, R = 4, lowered and unlowered, against JAX and the
  port's scan smoother: atol = rtol = 1e-5;
- ``fixed_point`` against ``iterate``: rtol 1e-5 (tests/test_lowering.py);
- mean-field and structured VMP (n = 8, 4 iterations) against JAX: rtol 1e-4;
- error types and messages: equal, with the package's name taken out.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cortex_tpu_torch.compile as PC
import cortex_tpu_torch.compile.tracing as PT
from cortex_tpu_torch import convert
from cortex_tpu_torch.models import LGSSM
from cortex_tpu_torch.utils import tree

import cortex_tpu.compile as JC
import cortex_tpu.compile.tracing as JT
from test_torch_core import (
    PKGS,
    beta_bernoulli_rules,
    make_beta_bernoulli_graph,
    random_tree_model,
    tree_rules,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

JAXP, PORT = PKGS["jax"], PKGS["torch"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(d):
    return {f.name: _np(getattr(d, f.name)) for f in dataclasses.fields(d)}


def _assert_dist_close(port, ref, rtol, atol=0.0):
    assert type(port).__name__ == type(ref).__name__
    got, want = _fields(port), _fields(ref)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# -- smart_stack and product_reduce ----------------------------------------------


def _packs(seed, n=6, R=3, n_packs=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_packs):
        xi = rng.normal(size=(n, R)).astype(np.float32)
        w = rng.uniform(0.5, 2.0, size=(n, R)).astype(np.float32)
        out.append((PORT.dists.Gaussian(torch.from_numpy(xi), torch.from_numpy(w)),
                    JAXP.dists.Gaussian(jnp.asarray(xi), jnp.asarray(w))))
    return out


# (pack, row) requests, one for each branch of smart_stack.
SMART_STACK_CASES = {
    "whole pack": [(0, i) for i in range(6)],
    "ascending run": [(0, i) for i in range(1, 5)],
    "descending run": [(0, i) for i in range(5, 0, -1)],
    "two runs in two packs": [(0, 2), (0, 3), (1, 4), (1, 3)],
    "one-pack gather": [(0, i) for i in (0, 3, 1, 4, 2, 5, 0, 3, 5, 1, 4, 2, 0, 5, 3, 1, 2)],
    "cross-pack gather": [(p, i) for p, i in ((0, 0), (1, 3), (0, 5), (1, 1), (0, 2), (1, 4),
                                               (0, 1), (1, 0), (0, 4), (1, 5), (0, 3), (1, 2),
                                               (0, 5), (1, 1), (0, 0), (1, 3), (0, 2))],
}


@pytest.mark.parametrize("case", sorted(SMART_STACK_CASES))
def test_smart_stack_branches_match_jax(case):
    packs = _packs(0)
    rows = SMART_STACK_CASES[case]
    got = PC.smart_stack([PC.PackRef(packs[p][0], i, 6) for p, i in rows])
    want = JC.smart_stack([JC.PackRef(packs[p][1], i, 6) for p, i in rows])
    _assert_dist_close(got, want, rtol=0.0)
    if case == "whole pack":
        assert got is packs[0][0]


def test_smart_stack_of_heterogeneous_packs_falls_back_to_rows():
    """Packs of different widths: the concatenate fails with ValueError and
    the rows stack one by one, when their own shapes agree."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4, 2, 3)).astype(np.float32)
    for pkg, arr in ((PC, torch.from_numpy), (JC, jnp.asarray)):
        rows = [pkg.PackRef(arr(a), i, 4) for i in (0, 2, 1, 3, 0, 2, 3, 1, 0, 3)]
        assert tuple(pkg.smart_stack(rows).shape) == (10, 3)
        mixed = [pkg.PackRef(arr(b), 1, 4), pkg.PackRef(arr(a), 0, 4)] * 9
        with pytest.raises(ValueError):
            pkg.smart_stack(mixed)


@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("family", ["Gaussian", "Beta", "Gamma"])
def test_product_reduce_matches_jax(family, k):
    rng = np.random.default_rng(k)
    names = [f.name for f in dataclasses.fields(getattr(PORT.dists, family))]
    values = [{n: rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32) for n in names}
              for _ in range(k)]
    got = PC.product_reduce([getattr(PORT.dists, family)(
        **{n: torch.from_numpy(v) for n, v in d.items()}) for d in values])
    want = JC.product_reduce([getattr(JAXP.dists, family)(
        **{n: jnp.asarray(v) for n, v in d.items()}) for d in values])
    _assert_dist_close(got, want, rtol=1e-6)


def test_product_reduce_of_mismatched_shapes_folds_pairwise():
    shapes = [(3,), (1,), (3,)]
    for pkg, arr in ((PORT, torch.ones), (JAXP, jnp.ones)):
        out = pkg.compile.product_reduce([pkg.dists.Gaussian(arr(s), arr(s)) for s in shapes])
        np.testing.assert_array_equal(_np(out.xi), [3.0, 3.0, 3.0])


# -- Beta-Bernoulli -----------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 100])
def test_beta_bernoulli_matches_the_closed_form_and_jax(n):
    data = (np.random.default_rng(0).random(n) < 0.7).astype(np.float32)
    out = {}
    for name, pkg, arr in (("port", PORT, torch.tensor), ("jax", JAXP, jnp.asarray)):
        engine, p, o, f = make_beta_bernoulli_graph(pkg, n)
        compiled = pkg.compile.CompiledInference(engine, [p], beta_bernoulli_rules(pkg))
        inputs = {("message_to_factor", o[i], f[i]): arr(data[i]) for i in range(n)}
        out[name] = compiled(inputs)[p]
    np.testing.assert_allclose(float(out["port"].a), 1.0 + data.sum(), rtol=1e-6)
    np.testing.assert_allclose(float(out["port"].b), 1.0 + n - data.sum(), rtol=1e-6)
    _assert_dist_close(out["port"], out["jax"], rtol=1e-6)


def test_beta_bernoulli_replica_batched():
    n, R = 20, 8
    data = (np.random.default_rng(1).random((n, R)) < 0.3).astype(np.float32)
    engine, p, o, f = make_beta_bernoulli_graph(PORT, n)
    compiled = PC.CompiledInference(engine, [p], beta_bernoulli_rules(PORT))
    post = compiled({("message_to_factor", o[i], f[i]): torch.from_numpy(data[i])
                     for i in range(n)})[p]
    assert tuple(post.a.shape) == (R,)
    np.testing.assert_allclose(post.a.numpy(), 1.0 + data.sum(0), rtol=1e-6)
    np.testing.assert_allclose(post.b.numpy(), 1.0 + n - data.sum(0), rtol=1e-6)


# -- the BP chain -----------------------------------------------------------------------

T_CHAIN, R_CHAIN = 12, 4


def _chain_data(seed=0):
    return np.random.default_rng(seed).normal(size=(R_CHAIN, T_CHAIN)).cumsum(-1).astype(
        np.float32)


def _run_chain(pkg, y, lower=True):
    engine, x, _, _ = pkg.models.make_chain_graph(y.shape[1])
    compiled = pkg.compile.CompiledInference(engine, x, pkg.models.LGSSMChainBatched(),
                                             lower=lower)
    pack = torch.from_numpy(np.ascontiguousarray(y.T)) if pkg is PORT else jnp.asarray(y.T)
    marginals, _ = compiled.run({}, source_pack=pack, packed=True)
    fam = pkg.compile.smart_stack([marginals[v] for v in x])
    return compiled, fam


def test_chain_through_the_executor_matches_jax_and_the_scan_smoother():
    y = _chain_data()
    tol = dict(rtol=1e-5, atol=1e-5)
    compiled, lowered = _run_chain(PORT, y)
    assert compiled.plan is not None and compiled.plan.scan_segments
    _, unlowered = _run_chain(PORT, y, lower=False)
    _, jax_fam = _run_chain(JAXP, y)
    scan = LGSSM().smooth(torch.from_numpy(y), method="scan")
    for got in (lowered, unlowered):
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(jax_fam.mean), **tol)
        np.testing.assert_allclose(got.variance.numpy(), np.asarray(jax_fam.variance), **tol)
        np.testing.assert_allclose(got.mean.numpy().T, scan.mean.numpy(), **tol)
        np.testing.assert_allclose(got.variance.numpy().T, scan.variance.numpy(), **tol)
    np.testing.assert_allclose(lowered.mean.numpy(), unlowered.mean.numpy(), rtol=1e-6, atol=1e-7)


def test_chain_with_scalar_inputs_matches_jax():
    data = _chain_data(1)[0]
    out = {}
    for name, pkg, arr in (("port", PORT, torch.tensor), ("jax", JAXP, jnp.asarray)):
        engine, x, y, lik = pkg.models.make_chain_graph(T_CHAIN)
        compiled = pkg.compile.CompiledInference(engine, x, pkg.models.LGSSMChainBatched())
        marginals = compiled({("message_to_factor", y[i], lik[i]): arr(data[i])
                              for i in range(T_CHAIN)})
        out[name] = [(float(marginals[v].mean), float(marginals[v].variance)) for v in x]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_trees_match_jax(seed):
    out = {}
    for name, pkg, arr in (("port", PORT, torch.tensor), ("jax", JAXP, jnp.asarray)):
        engine, latents, observed = random_tree_model(pkg, seed)
        data = np.random.default_rng(seed).normal(size=(len(observed), 2)).astype(np.float32)
        compiled = pkg.compile.CompiledInference(engine, latents, tree_rules(pkg))
        marginals = compiled({("message_to_factor", o, f): arr(v)
                              for (o, f), v in zip(observed, data)})
        out[name] = [marginals[z] for z in latents]
    for got, want in zip(out["port"], out["jax"]):
        _assert_dist_close(got, want, rtol=1e-5, atol=1e-6)


# -- VMP graphs -----------------------------------------------------------------------

N_VMP, R_VMP, ITERS = 8, 4, 4


def _vmp(pkg, graph, n=N_VMP, R=R_VMP, seed=3):
    obs = (0.1 * np.random.default_rng(seed).normal(size=(R, n)).cumsum(-1)).astype(np.float32)
    make = (pkg.models.make_mean_field_ssm_graph if graph == "mean_field"
            else pkg.models.make_structured_ssm_graph)
    engine, x, _, ss, on = make(n, [obs[:, i] for i in range(n)], **pkg.kw)
    processor = (pkg.models.MeanFieldSSMBatched() if graph == "mean_field"
                 else pkg.models.StructuredSSMBatched())
    compiled = pkg.compile.CompiledInference(engine, [ss, on] + x, processor,
                                             refine_key=pkg.compile.dep_role_key)
    return compiled, [ss, on] + x


def _broadcast(pkg, state, R):
    """The compile-time state with scalar leaves broadcast to R replicas."""
    if pkg is PORT:
        return [tree.tree_map(lambda a: a.expand((R,)) if a.dim() == 0 else a, v) for v in state]
    return [jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (R,)) if a.ndim == 0 else a, v)
            for v in state]


@pytest.mark.parametrize("steady_state", [False, True])
@pytest.mark.parametrize("graph", ["mean_field", "structured"])
def test_vmp_graphs_match_jax(graph, steady_state):
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAXP)):
        compiled, targets = _vmp(pkg, graph)
        marginals, state = compiled.iterate(
            {}, ITERS, _broadcast(pkg, compiled.initial_state(), R_VMP), steady_state=steady_state)
        out[name] = ([marginals[v] for v in targets], state)
    for got, want in zip(out["port"][0], out["jax"][0]):
        _assert_dist_close(got, want, rtol=1e-4, atol=1e-6)
    assert len(out["port"][1]) == len(out["jax"][1])


@pytest.mark.parametrize("mode", ["steady_state", "dataflow"])
def test_fixed_point_matches_iterate_and_jax(mode):
    compiled, targets = _vmp(PORT, "mean_field", n=12, R=2)
    state = _broadcast(PORT, compiled.initial_state(), 2)
    fp, _ = compiled.fixed_point({}, 20, state, mode=mode)
    it, _ = compiled.iterate({}, 20, state, steady_state=mode == "steady_state")
    jcompiled, jtargets = _vmp(JAXP, "mean_field", n=12, R=2)
    jfp, _ = jcompiled.fixed_point({}, 20, _broadcast(JAXP, jcompiled.initial_state(), 2),
                                   mode=mode)
    for v, jv in zip(targets, jtargets):
        _assert_dist_close(fp[v], it[v], rtol=1e-5, atol=1e-6)
        _assert_dist_close(fp[v], jfp[jv], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["steady_state", "dataflow"])
def test_fixed_point_on_the_lowered_chain(mode):
    y = _chain_data(2)
    engine, x, _, _ = PORT.models.make_chain_graph(T_CHAIN)
    compiled = PC.CompiledInference(engine, x, PORT.models.LGSSMChainBatched())
    marginals, _ = compiled.fixed_point({}, 4, mode=mode,
                                        source_pack=torch.from_numpy(np.ascontiguousarray(y.T)))
    fam = PC.smart_stack([marginals[v] for v in x])
    scan = LGSSM().smooth(torch.from_numpy(y), method="scan")
    np.testing.assert_allclose(fam.mean.numpy().T, scan.mean.numpy(), rtol=1e-5, atol=1e-5)


def test_n_iterations_below_one_raises_in_both():
    for pkg in (PORT, JAXP):
        compiled, _ = _vmp(pkg, "mean_field", n=4, R=1)
        for call in (lambda: compiled.iterate({}, 0),
                     lambda: compiled.fixed_point({}, 0),
                     lambda: compiled.fixed_point({}, 1, mode="other")):
            with pytest.raises(ValueError):
                call()


# -- tracing --------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["chain", "structured"])
def test_trace_run_records_the_same_groups_as_jax(graph):
    out = {}
    for name, pkg, tr in (("port", PORT, PT), ("jax", JAXP, JT)):
        if graph == "chain":
            engine, x, y, lik = pkg.models.make_chain_graph(T_CHAIN)
            compiled = pkg.compile.CompiledInference(engine, x, pkg.models.LGSSMChainBatched())
            arr = torch.tensor if pkg is PORT else jnp.asarray
            inputs = {("message_to_factor", y[i], lik[i]): arr(np.float32(i))
                      for i in range(T_CHAIN)}
            sweep = tr.trace_run(compiled, inputs, snapshot_values=True)
        else:
            compiled, _ = _vmp(pkg, graph)
            sweep = tr.trace_run(compiled, {}, _broadcast(pkg, compiled.initial_state(), R_VMP))
        out[name] = ([(g.phase, g.key, g.n_steps) for g in sweep.groups], sweep)
    assert out["port"][0] == out["jax"][0]
    sweep = out["port"][1]
    assert sweep.total_ns > 0 and all(g.wall_ns > 0 for g in sweep.groups)
    assert "TracedSweep(total = " in repr(sweep)
    for vid, value in sweep.marginals.items():
        _assert_dist_close(value, out["jax"][1].marginals[vid], rtol=1e-4, atol=1e-6)


def test_profile_run_writes_a_trace(tmp_path):
    compiled, _ = _vmp(PORT, "mean_field", n=4, R=2)
    with PT.profile_run(str(tmp_path / "trace")) as prof:
        compiled.iterate({}, 2, _broadcast(PORT, compiled.initial_state(), 2))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


# -- errors -----------------------------------------------------------------------------


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value).replace("cortex_tpu_torch", "cortex_tpu")


def _heterogeneous_group(pkg):
    """Beta-Bernoulli whose observations have two shapes: one rule group
    cannot stack them."""
    engine, p, o, f = make_beta_bernoulli_graph(pkg, 4)
    compiled = pkg.compile.CompiledInference(engine, [p], beta_bernoulli_rules(pkg))
    zeros = torch.zeros if pkg is PORT else jnp.zeros
    return lambda: compiled({("message_to_factor", o[i], f[i]): zeros((2 + i % 2,))
                             for i in range(4)})


def _heterogeneous_scan(pkg):
    """The lowered chain whose observations have two shapes."""
    engine, x, y, lik = pkg.models.make_chain_graph(T_CHAIN)
    compiled = pkg.compile.CompiledInference(engine, x, pkg.models.LGSSMChainBatched())
    zeros = torch.zeros if pkg is PORT else jnp.zeros
    return lambda: compiled({("message_to_factor", y[i], lik[i]): zeros((2 + (i > 5),))
                             for i in range(T_CHAIN)})


def _wrong_batch(pkg):
    class Wrong(pkg.compile.BatchedProcessor):
        def compute_message_to_variable(self, engine, variants, dep_values):
            y = dep_values[0][:1]
            return pkg.dists.Beta(1.0 + y, 2.0 - y)

    engine, p, o, f = make_beta_bernoulli_graph(pkg, 3)
    compiled = pkg.compile.CompiledInference(engine, [p], Wrong())
    arr = torch.tensor if pkg is PORT else jnp.asarray
    return lambda: compiled({("message_to_factor", o[i], f[i]): arr(1.0) for i in range(3)})


@pytest.mark.parametrize("case", [_heterogeneous_group, _heterogeneous_scan, _wrong_batch])
def test_errors_have_the_type_and_message_of_jax(case):
    got = _error(case(PORT))
    assert got == _error(case(JAXP))
    assert got[0] in (TypeError, ValueError)


def test_stack_and_concatenate_raise_value_error():
    with pytest.raises(ValueError):
        tree.stack([torch.zeros(2), torch.zeros(3)])
    with pytest.raises(ValueError):
        tree.concatenate([torch.zeros(2, 2), torch.zeros(2, 3)])
    with pytest.raises(ValueError):
        PC.tree_stack([PORT.dists.Gaussian(torch.zeros(2), torch.zeros(2)),
                       PORT.dists.Gamma(torch.zeros(2), torch.zeros(2))])


# -- convert ------------------------------------------------------------------------------


def _as_numpy(value):
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, {k: np.asarray(v) for k, v in _fields(value).items()})
    return np.asarray(value)


@pytest.mark.parametrize("graph", ["mean_field", "structured"])
def test_convert_carries_a_vmp_state_across(graph):
    """Two iterations in JAX, the state carried across, two more in each
    package: the same marginals as four in JAX."""
    jcompiled, jtargets = _vmp(JAXP, graph)
    jstate0 = _broadcast(JAXP, jcompiled.initial_state(), R_VMP)
    _, jstate = jcompiled.iterate({}, 2, jstate0)
    jmarg, _ = jcompiled.iterate({}, 2, jstate)
    compiled, targets = _vmp(PORT, graph)
    state = convert.dists_from_numpy([_as_numpy(v) for v in jstate], device="cpu")
    assert [type(v).__name__ for v in state if not isinstance(v, torch.Tensor)] == [
        type(v).__name__ for v in jstate if dataclasses.is_dataclass(v)]
    marg, _ = compiled.iterate({}, 2, state)
    for v, jv in zip(targets, jtargets):
        _assert_dist_close(marg[v], jmarg[jv], rtol=1e-4, atol=1e-6)
    initial = convert.dists_from_numpy([_as_numpy(v) for v in jcompiled.initial_state()],
                                       device="cpu")
    for got, want in zip(initial, compiled.initial_state()):
        if isinstance(got, torch.Tensor):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            for k, a in _fields(got).items():
                np.testing.assert_array_equal(a, _fields(want)[k])


def test_dist_from_numpy_checks_its_input():
    g = convert.dist_from_numpy("Gaussian", {"xi": np.zeros(2, np.float32),
                                             "w": np.ones(2, np.float32)}, device="cpu")
    assert isinstance(g, PORT.dists.Gaussian) and g.w.dtype == torch.float32
    with pytest.raises(ValueError):
        convert.dist_from_numpy("Wishart", {}, device="cpu")
    with pytest.raises(ValueError):
        convert.dist_from_numpy("Gamma", {"shape": 1.0}, device="cpu")


# -- chip_smoke.py's generic phase, rehearsed ------------------------------------------


def test_chip_smoke_generic_main_path_rehearses_on_cpu():
    """chip_smoke's generic phase at a small size on the CPU: every check
    passes, the hand-written sweep included."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    checks = smoke.run_generic_main_path(torch, LGSSM, "cpu", R=48, T=20, n_cpu=16)
    assert {c["against"] for c in checks} == {
        "float64 RTS", "LGSSM.smooth scan", "lower=False", "hand-written sweep", "port on cpu",
        "iterate"}
    assert len(checks) == 10
