"""Port parity: ``cortex_tpu_torch.viz`` and ``cortex_tpu_torch.checkpoint``
against the JAX package's.

The cases of ``tests/test_viz_checkpoint.py`` run on the port.  The DOT
renderer is a copy, so each graph, built the same way in both packages,
renders to the same text.  Checkpoints keep the JAX package's file layout:
the structure's text is JAX's, the HGF stream resumes within 1e-5 of JAX's
(the HGF tests' bar), bfloat16 leaves come back bit for bit, named tuples and
``None`` keep their place, and ``convert.checkpoint_from_jax`` reads a file
that the JAX package wrote and resumes the port's filter from it.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cortex_tpu_torch
import cortex_tpu_torch.compile
import cortex_tpu_torch.dists
import cortex_tpu_torch.viz
from cortex_tpu_torch import convert
from cortex_tpu_torch.checkpoint import CheckpointManager, restore, save
from cortex_tpu_torch.models.hgf import HGF, HGFState
from cortex_tpu_torch.ops.kernels_hgf import hgf_filter_fused

import cortex_tpu
import cortex_tpu.checkpoint
import cortex_tpu.compile
import cortex_tpu.dists
import cortex_tpu.viz
from cortex_tpu.models.hgf import HGF as JaxHGF

PKGS = {
    "jax": types.SimpleNamespace(core=cortex_tpu, compile=cortex_tpu.compile,
                                 viz=cortex_tpu.viz),
    "torch": types.SimpleNamespace(core=cortex_tpu_torch, compile=cortex_tpu_torch.compile,
                                   viz=cortex_tpu_torch.viz),
}
HGF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(build):
    """``build(pkg)`` in each package; the port's DOT text must equal JAX's."""
    dots = {name: build(pkg) for name, pkg in PKGS.items()}
    assert dots["torch"] == dots["jax"]
    return dots["torch"]


# -- signal_to_dot ----------------------------------------------------------


def test_dot_state_colors():
    def build(pkg):
        s1 = pkg.core.Signal(1)
        pending = pkg.core.Signal()
        pending.add_dependency(s1)
        return pkg.viz.signal_to_dot(pending)

    dot = _both(build)
    assert "digraph" in dot
    assert "lightblue" in dot
    assert "lightyellow" in dot


def test_dot_edge_styles():
    def build(pkg):
        derived = pkg.core.Signal()
        derived.add_dependency(pkg.core.Signal(1), weak=True)
        derived.add_dependency(pkg.core.Signal(2), intermediate=True)
        return pkg.viz.signal_to_dot(derived)

    dot = _both(build)
    assert "dashed" in dot
    assert "color=gray" in dot or "color=blue" in dot


def test_dot_bounded_with_summary_nodes():
    def build(pkg):
        derived = pkg.core.Signal()
        for i in range(20):
            derived.add_dependency(pkg.core.Signal(i))
        return pkg.viz.signal_to_dot(derived, max_dependencies=5)

    assert "15 more" in _both(build)


def _one_prior(pkg):
    c = pkg.core
    g = c.BipartiteFactorGraph()
    v = g.add_variable(c.Variable(name="v"))
    f = g.add_factor(c.Factor(functional_form="prior"))
    g.add_edge(v, f, c.Connection(label="out"))
    return c.InferenceEngine(model_engine=g), v, f


def test_dot_variant_labels():
    def build(pkg):
        engine, v, _ = _one_prior(pkg)
        return pkg.viz.signal_to_dot(engine.get_variable_marginal(v))

    dot = _both(build)
    assert "IndividualMarginal" in dot
    assert "MessageToVariable" in dot


def test_dot_depth_bounded():
    def build(pkg):
        chain = [pkg.core.Signal(0)]
        for _ in range(10):
            s = pkg.core.Signal()
            s.add_dependency(chain[-1])
            chain.append(s)
        return pkg.viz.signal_to_dot(chain[-1], max_depth=2, include_listeners=False)

    assert _both(build).count("[label=") <= 4


@pytest.mark.parametrize("knob", ["no variant", "no value", "custom"])
def test_dot_display_knobs(knob):
    """show_value / show_variant / variant_to_string_fn, as the reference's
    GraphViz.load keywords."""
    def build(pkg):
        engine, v, _ = _one_prior(pkg)
        marginal = engine.get_variable_marginal(v)
        kwargs = {"no variant": {"show_variant": False}, "no value": {"show_value": False},
                  "custom": {"variant_to_string_fn": lambda var: f"V<{type(var).__name__}>"}}
        return pkg.viz.signal_to_dot(marginal, **kwargs[knob])

    dot = _both(build)
    absent = {"no variant": "IndividualMarginal", "no value": "#undef"}
    if knob in absent:
        assert absent[knob] not in dot
    else:
        assert "V<IndividualMarginal>" in dot


def test_dot_listeners_add_nodes():
    def build(pkg, show):
        engine, v, f = _one_prior(pkg)
        return pkg.viz.signal_to_dot(engine.get_message_to_variable(v, f), show_listeners=show)

    with_l = _both(lambda pkg: build(pkg, True))
    without_l = _both(lambda pkg: build(pkg, False))
    assert with_l.count("[label=") > without_l.count("[label=")


def test_render_signal_svg():
    """Rendered-output parity with the reference's SVG-content assertions;
    skipped where graphviz's ``dot`` binary is not installed."""
    if shutil.which("dot") is None:
        pytest.skip("graphviz 'dot' binary not installed")
    s1 = cortex_tpu_torch.Signal(1)
    pending = cortex_tpu_torch.Signal()
    pending.add_dependency(s1)
    svg = cortex_tpu_torch.viz.render_signal(pending, format="svg").decode()
    assert "<svg" in svg
    assert "lightblue" in svg


def test_render_dot_clear_error_without_binary(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="dot"):
        cortex_tpu_torch.viz.render_dot("digraph G {}")


# -- schedule_to_dot --------------------------------------------------------


def test_schedule_dot():
    def build(pkg):
        c = pkg.core
        g = c.BipartiteFactorGraph()
        p = g.add_variable(c.Variable(name="p"))
        for i in range(10):
            o = g.add_variable(c.Variable(name="o", index=(i,)))
            f = g.add_factor(c.Factor(functional_form="bernoulli"))
            g.add_edge(p, f, c.Connection(label="out"))
            g.add_edge(o, f, c.Connection(label="out"))
        engine = c.InferenceEngine(model_engine=g)
        return pkg.viz.schedule_to_dot(pkg.compile.extract_schedule(engine, [p]))

    dot = _both(build)
    assert "sources" in dot
    assert "MessageToVariable [bernoulli]" in dot
    assert "IndividualMarginal" in dot


# -- checkpoint -------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    from cortex_tpu_torch.dists import from_mean_variance

    state = {"gauss": from_mean_variance(torch.arange(4.0), torch.ones(4)),
             "step": torch.tensor(7, dtype=torch.int32)}
    path = str(tmp_path / "state.npz")
    save(path, state)
    like = {"gauss": from_mean_variance(torch.zeros(4), torch.ones(4)),
            "step": torch.tensor(0, dtype=torch.int32)}
    loaded = restore(path, like)
    np.testing.assert_allclose(loaded["gauss"].xi.numpy(), np.arange(4.0))
    assert int(loaded["step"]) == 7
    assert type(loaded["gauss"]) is type(state["gauss"])

    # The JAX package writes the same entries and the same structure text.
    jax_path = str(tmp_path / "jax.npz")
    cortex_tpu.checkpoint.save(jax_path, {
        "gauss": cortex_tpu.dists.from_mean_variance(jnp.arange(4.0), jnp.ones(4)),
        "step": jnp.asarray(7)})
    with np.load(path) as ours, np.load(jax_path) as theirs:
        assert set(theirs.files) <= set(ours.files)
        assert bytes(ours["__treedef_repr__"]) == bytes(theirs["__treedef_repr__"])
        for key in ("leaf_0", "leaf_1", "leaf_2"):
            np.testing.assert_array_equal(ours[key], theirs[key])


def test_restore_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "state.npz")
    save(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore(path, {"b": (torch.zeros(3), torch.zeros(3))})


def test_checkpoint_manager_retention_and_resume(tmp_path):
    """The port's HGF streamed by chunks, checkpointed with retention, and
    restored exactly; the stream tracks JAX's at the HGF tests' bar."""
    hgf, jhgf = HGF(), JaxHGF()
    manager = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    state = hgf.init_state((4,), device="cpu")
    jstate = jhgf.init_state((4,))
    rng = np.random.default_rng(0)
    for step in range(5):
        chunk = rng.normal(size=(4, 10)).astype(np.float32)
        state, _ = hgf.filter(torch.from_numpy(chunk), state=state)
        jstate, _ = jhgf.filter(jnp.asarray(chunk), state=jstate)
        manager.save(step, state)

    assert manager.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["ckpt_3.npz", "ckpt_4.npz"]
    resumed = manager.restore(hgf.init_state((4,), device="cpu"))
    assert type(resumed) is HGFState
    for got, want, jax_want in zip(resumed, state, jstate):
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), **HGF_TOL)


def test_checkpoint_manager_empty_raises(tmp_path):
    manager = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        manager.restore(torch.zeros(2))


def test_bfloat16_leaves_restore_bit_for_bit(tmp_path):
    """K4's bf16 tracks (numpy has no bfloat16) are stored as their 16 bits
    and come back bit for bit; every leaf keeps its saved dtype."""
    u = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 20)).cumsum(-1)
                         .astype(np.float32))
    finals, tracks = hgf_filter_fused(u, tracks=("mu1", "mu2"), track_dtype=torch.bfloat16)
    tree = {"finals": finals, "tracks": list(tracks), "f64": torch.arange(3.0).double()}
    path = str(tmp_path / "bf16.npz")
    save(path, tree)
    like = {"finals": tuple(torch.zeros(6) for _ in finals),
            "tracks": [torch.zeros(6, 20, dtype=torch.bfloat16) for _ in tracks],
            "f64": torch.zeros(3)}
    loaded = restore(path, like)
    for got, want in zip(loaded["tracks"], tracks):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert loaded["f64"].dtype == torch.float64
    assert all(torch.equal(g, w) for g, w in zip(loaded["finals"], finals))


def test_named_tuples_and_none_round_trip(tmp_path):
    """An HGF trajectory keeps its class and the ``None`` of each track not
    asked for (``None`` is a node with no leaves, as in JAX)."""
    hgf = HGF()
    u = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32))
    state, traj = hgf.filter(u, tracks=("mu1", "delta1"))
    path = str(tmp_path / "traj.npz")
    save(path, (state, traj))
    like = (hgf.init_state((3,), device="cpu"), traj._replace(
        mu1=torch.zeros(3, 8), prediction_error=torch.zeros(3, 8)))
    got_state, got_traj = restore(path, like)
    assert type(got_state) is HGFState and type(got_traj) is type(traj)
    assert got_traj.pi1 is None and got_traj.mu2 is None
    assert torch.equal(got_traj.mu1, traj.mu1)
    assert torch.equal(got_traj.prediction_error, traj.prediction_error)
    assert all(torch.equal(g, w) for g, w in zip(got_state, state))


def test_checkpoint_from_jax_resumes_the_hgf(tmp_path):
    """A state and a Gaussian saved by the JAX package, read into the port's
    structure; the port's filter resumed from the state tracks JAX's
    continued run within 1e-5."""
    rng = np.random.default_rng(3)
    first, second = (rng.normal(size=(5, 12)).cumsum(-1).astype(np.float32) for _ in range(2))
    jhgf, hgf = JaxHGF(), HGF()
    jstate, _ = jhgf.filter(jnp.asarray(first))
    path = str(tmp_path / "jax.npz")
    cortex_tpu.checkpoint.save(path, {
        "state": jstate,
        "belief": cortex_tpu.dists.from_mean_variance(jnp.arange(5.0), jnp.full(5, 2.0))})
    like = {"state": hgf.init_state((5,), device="cpu"),
            "belief": cortex_tpu_torch.dists.from_mean_variance(torch.zeros(5), torch.ones(5))}
    loaded = convert.checkpoint_from_jax(path, like, device="cpu")
    assert type(loaded["state"]) is HGFState
    np.testing.assert_array_equal(loaded["belief"].xi.numpy(), np.arange(5.0) / 2.0)
    for got, want in zip(loaded["state"], jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_state, got_traj = hgf.filter(torch.from_numpy(second), state=loaded["state"])
    want_state, want_traj = jhgf.filter(jnp.asarray(second), state=jstate)
    for got, want in zip(got_state, want_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **HGF_TOL)
    np.testing.assert_allclose(got_traj.mu2.numpy(), np.asarray(want_traj.mu2), **HGF_TOL)

    with pytest.raises(ValueError, match="leaf 0"):
        convert.checkpoint_from_jax(path, {**like, "belief": cortex_tpu_torch.dists
                                           .from_mean_variance(torch.zeros(4), torch.ones(4))},
                                    device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        convert.checkpoint_from_jax(path, {"state": like["state"]}, device="cpu")


def test_tree_helper_keeps_named_tuples_and_none_as_jax():
    """The port's tree helper rebuilds a named tuple as its class (it once
    gave a plain tuple) and takes ``None`` as a node with no leaves; its
    structure text and leaf paths are jax.tree_util's."""
    import jax

    from cortex_tpu_torch.utils import tree

    state = HGF().init_state((4,), device="cpu")
    leaves, treedef = tree.tree_flatten(state)
    rebuilt = tree.tree_unflatten(treedef, leaves)
    assert type(rebuilt) is HGFState and rebuilt._fields == state._fields
    assert type(tree.tree_map(lambda t: t + 1, state)) is HGFState

    ours = {"s": state, "n": None, "l": [torch.ones(2), (torch.zeros(1),)],
            "g": cortex_tpu_torch.dists.from_mean_variance(torch.zeros(2), torch.ones(2))}
    theirs = {"s": JaxHGF().init_state((4,)), "n": None, "l": [jnp.ones(2), (jnp.zeros(1),)],
              "g": cortex_tpu.dists.from_mean_variance(jnp.zeros(2), jnp.ones(2))}
    pairs, ours_def = tree.tree_flatten_with_path(ours)
    jpairs, theirs_def = jax.tree_util.tree_flatten_with_path(theirs)
    assert tree.treedef_str(ours_def) == str(theirs_def)
    assert [tree.keystr(p) for p, _ in pairs] == [jax.tree_util.keystr(p) for p, _ in jpairs]
    assert tree.tree_leaves(None) == [] and tree.tree_map(lambda t: 0, {"a": None}) == {"a": None}
