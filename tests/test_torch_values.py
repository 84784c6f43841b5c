"""The port's values compute as the JAX package's do, whatever they are built
from.

The walk below takes every public class of ``cortex_tpu.dists`` and every
public named tuple and dataclass of ``cortex_tpu.models``, beside its
counterpart in the port, and every public method and property of each
(``*`` and ``/`` too), and calls each on the same parameters made from a
seed with numpy, given in four kinds:

- ``tensor``: float32 tensors (JAX: float32 arrays);
- ``numpy``: float64 numpy, one of them a reversed view (negative strides);
- ``python``: Python floats, where every value is a scalar;
- ``mixed``: the object's fields numpy and the arguments tensors (an object
  with no array field: its last argument numpy; a call with no array
  argument: the object's last field a tensor).

The JAX package converts a value that is not an array where its first
``jnp`` call takes it and leaves plain arithmetic on numpy to numpy; the
port must give the same kind of result (a tensor where JAX gives an array,
numpy float64 or a Python float where JAX does), of the same dtype and shape,
with values within the JAX tests' bars for the function: 1e-6 (relative and
absolute) for the Gaussians' and the containers' plain arithmetic, 1e-5
where digamma and log-gamma are evaluated by two libraries or a matrix is
eliminated.  Draws are held by kind, dtype, shape and device against JAX's,
and, from numpy and from Python values, by moments as the port's dist tests
hold them: over 200,000 draws the sample mean is within 5 standard errors of
JAX's mean (tensors rounded from the same numpy draw the same numbers).  Here, without a
card, the module-level default device is the CPU, so that both packages
compute on the same host arrays; where nothing is patched, values with no
tensor beside them go to the card.

A method that cannot be called by the walk stands in ``EXCLUDED`` with its
reason, so that a method added later is walked, or fails the walk, by
default.
"""

import dataclasses
import functools
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import cortex_tpu_torch.dists as P
import cortex_tpu_torch.models as PM
from cortex_tpu_torch.utils import tree

import cortex_tpu.dists as J
import cortex_tpu.models as JM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them,
    8-20x slower on small tensors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def on_cpu(monkeypatch):
    """Values with no tensor beside them go to the CPU, not to the card."""
    monkeypatch.setattr(tree, "DEFAULT_DEVICE", "cpu")


REPO = Path(__file__).resolve().parents[1]
B, K, D, N_DRAWS = (3,), 4, 2, 200_000
PLAIN, SPECIAL = (1e-6, 1e-6), (1e-5, 1e-5)


# -- recipes: the parameters as float64 numpy, realized in a kind for a package ---------


@dataclasses.dataclass(frozen=True)
class Inst:
    """An instance of the class named ``name`` with ``fields`` (numpy arrays
    are realized in the case's kind; anything else is passed as it is)."""

    name: str
    fields: dict


class Key:
    """A ``torch.Generator`` for the port, a PRNG key for JAX."""


class DType:
    """``torch.float32`` for the port, ``jnp.float32`` for JAX."""


def _pos(rng, shape, low=0.5, high=3.0):
    return np.asarray(rng.uniform(low, high, shape))


def _normal(rng, shape):
    return np.asarray(rng.normal(size=shape))


def _spd(rng, shape, d=D):
    a = rng.normal(size=shape + (d, d))
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d)


def _chol_param(rng):
    return np.tril(0.3 * rng.normal(size=(D, D)))


def _dists(rng, b):
    """Fields of each distribution (batch ``b``)."""
    return {
        "Gaussian": dict(xi=_normal(rng, b), w=_pos(rng, b)),
        "MvGaussian": dict(xi=_normal(rng, b + (D,)), W=_spd(rng, b)),
        "Beta": dict(a=_pos(rng, b), b=_pos(rng, b)),
        "Gamma": dict(shape=_pos(rng, b), rate=_pos(rng, b)),
        "Bernoulli": dict(logit=_normal(rng, b)),
        "Categorical": dict(logits=_normal(rng, b + (K,))),
        "Dirichlet": dict(alpha=_pos(rng, b + (K,))),
        "NormalGamma": dict(m=_normal(rng, b), beta=_pos(rng, b), a=_pos(rng, b),
                            b=_pos(rng, b)),
        "Wishart": dict(n=_pos(rng, b, D + 1.0, D + 4.0), V=_spd(rng, b)),
        "Poisson": dict(log_rate=_normal(rng, b)),
    }


def _models(rng, b):
    """Fields of each value type of the models (batch ``b`` where it has one)."""
    return {
        "LGSSMParams": dict(A=_normal(rng, b), log_Q=_normal(rng, b), log_R=_normal(rng, b)),
        "MvLGSSMParams": dict(A=0.5 * _normal(rng, (D, D)), q_chol=_chol_param(rng),
                              r_chol=_chol_param(rng)),
        "NIGPosterior": dict(mean=_normal(rng, b + (D,)), cov_scale=_spd(rng, b),
                             a=_pos(rng, b, 1.5, 4.0), b=_pos(rng, b),
                             log_evidence=_normal(rng, b)),
        "PoissonPosterior": dict(mean=0.3 * _normal(rng, (D,)), cov=0.1 * _spd(rng, ()),
                                 ep=None),
        "EPClassifierPosterior": dict(mean=_normal(rng, (D,)), cov=_spd(rng, ()), ep=None,
                                      likelihood="logit"),
        "GMMPosterior": dict(alpha=_pos(rng, B + (K,)), m=_normal(rng, B + (K, D)),
                             beta=_pos(rng, B + (K, D)), a=_pos(rng, B + (K, D)),
                             b=_pos(rng, B + (K, D))),
        "GMMFullPosterior": dict(alpha=_pos(rng, B + (K,)), m=_normal(rng, B + (K, D)),
                                 beta=_pos(rng, B + (K,)), W=_spd(rng, B + (K,)),
                                 nu=_pos(rng, B + (K,), D + 1.5, D + 5.0)),
        "GaussianNIG": {},
        "BernoulliBeta": {},
        "BayesianLinearRegression": {},
    }


def _fields(name, b, seed=0):
    rng = np.random.default_rng(seed)
    table = {**_dists(rng, b), **_models(rng, b)}
    return table[name]


def _other(name, b=B):
    return Inst(name, _fields(name, b, seed=1))


def _stacked(name, b=B):
    return Inst(name, {k: np.stack([_fields(name, b, s)[k] for s in (2, 3, 4)])
                       for k in _fields(name, b)})


_XS = np.random.default_rng(5).normal(size=(5, D))
_STATS_Y = np.random.default_rng(6).normal(size=B)
_N = np.random.default_rng(7).uniform(1.0, 8.0, B + (6,))
_S = np.random.default_rng(10).normal(size=B + (6,))
_STATS = (_N, _S, _S * _S / _N + 0.5)  # q ≥ s²/n: a valid window
_COUNTS = tuple(np.random.default_rng(8).integers(0, 5, (2,) + B + (6,)).astype(np.float64))
_FLIPS = (np.random.default_rng(9).random(B) < 0.5).astype(np.float64)


def _args(cls, method, b):
    """The arguments of ``cls.method`` at batch ``b`` (recipe form)."""
    rng = np.random.default_rng(11)
    point = {"Beta": lambda: _pos(rng, b, 0.05, 0.95), "Gamma": lambda: _pos(rng, b),
             "Gaussian": lambda: _normal(rng, b), "MvGaussian": lambda: _normal(rng, b + (D,)),
             "NormalGamma": lambda: _normal(rng, b),
             "Poisson": lambda: np.asarray(rng.integers(0, 6, b)).astype(np.float64)}
    if method in ("__mul__", "__truediv__", "kl"):
        return (_other(cls, b),)
    if method == "reduce_product":
        return (_stacked(cls, b), 0)
    if method == "sample":
        return (Key, (2,)) if cls != "Wishart" else (Key,)
    if method in ("logpdf", "logpmf", "expected_tau_sq_diff"):
        return (point[cls](),)
    if method == "from_prob":
        return (_pos(rng, b, 0.05, 0.95),)
    if method == "from_probs":
        p = _pos(rng, b + (K,))
        return (p / p.sum(-1, keepdims=True),)
    if method in ("from_rate",):
        return (_pos(rng, b),)
    if method == "from_shape_scale":
        return (_pos(rng, b), _pos(rng, b))
    if method in ("predict_rate", "latent", "predict_proba", "predict"):
        return (_XS,)
    if method == "init_stats":
        return (B + (6,), DType)
    if method in ("update_stats", "pred_logpdf"):
        return ((_COUNTS, _FLIPS) if cls == "BernoulliBeta" else (_STATS, _STATS_Y))
    if method == "predictive":
        return (Inst("NIGPosterior", _fields("NIGPosterior", ())), _XS)
    return ()


def _array_leaves(x):
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, Inst):
        return [a for v in x.fields.values() for a in _array_leaves(v)]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _array_leaves(v)]
    return []


def _realize(x, pkg, kind_of):
    """``x`` (recipe form) for package ``pkg`` ("port"/"jax"), each array in
    the kind ``kind_of(array)`` gives ("tensor", "numpy", "reversed" or
    "python")."""
    if isinstance(x, np.ndarray):
        kind = kind_of(x)
        if kind == "python":
            return float(x)
        if kind == "numpy":
            return x
        if kind == "reversed":
            return np.ascontiguousarray(x[..., ::-1])[..., ::-1]
        f32 = np.array(x, dtype=np.float32, order="C")
        return torch.from_numpy(f32) if pkg == "port" else jnp.asarray(f32)
    if isinstance(x, Inst):
        cls = _classes(x.name)[pkg == "port"]
        return cls(**{k: _realize(v, pkg, kind_of) for k, v in x.fields.items()})
    if x is Key:
        return torch.Generator().manual_seed(0) if pkg == "port" else jax.random.PRNGKey(0)
    if x is DType:
        return torch.float32 if pkg == "port" else jnp.float32
    if isinstance(x, tuple):
        return tuple(_realize(v, pkg, kind_of) for v in x)
    return x


def _classes(name):
    """(JAX class, port class) named ``name``."""
    jmod, pmod = (J, P) if hasattr(J, name) else (JM, PM)
    return getattr(jmod, name), getattr(pmod, name)


def _kinds(self_leaves, arg_leaves):
    """``{kind: {id(array): its kind}}`` for the kinds but ``python``: each
    array's kind in it (an array not named is a tensor)."""
    leaves = self_leaves + arg_leaves
    first = next((a for a in leaves if a.ndim and a.shape[-1] > 1), None)
    kinds = {"tensor": {}}
    if leaves:
        kinds["numpy"] = {id(a): "reversed" if a is first else "numpy" for a in leaves}
    if len(leaves) > 1:
        if self_leaves and arg_leaves:
            numpy = self_leaves
        elif arg_leaves:
            numpy = arg_leaves[-1:]
        else:
            numpy = self_leaves[:-1]
        kinds["mixed"] = {id(a): "numpy" for a in numpy}
    return kinds


# -- the walk -------------------------------------------------------------------------------


def _value_classes():
    """``{name: (JAX class, port class)}``: the public classes of the dists and
    the public named tuples and dataclasses of the models (an alias once)."""
    out, seen = {}, set()
    for jmod, pmod, every in ((J, P, True), (JM, PM, False)):
        for name in jmod.__all__:
            cls = getattr(jmod, name)
            if not inspect.isclass(cls) or cls in seen:
                continue
            is_value = dataclasses.is_dataclass(cls) or (issubclass(cls, tuple)
                                                         and hasattr(cls, "_fields"))
            if every or is_value:
                seen.add(cls)
                out[cls.__name__] = (cls, getattr(pmod, cls.__name__))
    return out


CLASSES = _value_classes()


def _public(cls):
    """Own public methods and properties of ``cls`` (``*`` and ``/`` too)."""
    return [k for k, v in vars(cls).items()
            if (not k.startswith("_") or k in ("__mul__", "__truediv__"))
            and (callable(v) or isinstance(v, (property, classmethod, staticmethod)))]


ENTRY_POINT = ("a model's entry point, which takes series, designs or iteration counts "
               "rather than values: the boundary rule converts its inputs, and "
               "test_torch_boundary.py holds entry points fed numpy against JAX")

MODULE = ("the port's torch.nn.Module side of a model (its repr, forward, and the accessors "
          "of its buffers): no counterpart in the JAX package")

# (class, method): why the walk does not call it.
EXCLUDED = {
    **{("LGSSM", m): ENTRY_POINT for m in ("smooth", "filter", "log_evidence", "sample")},
    **{("MvLGSSM", m): ENTRY_POINT for m in ("from_arrays", "dim", "auto_method", "smooth",
                                              "filter", "log_evidence", "sample")},
    **{("HMM", m): ENTRY_POINT for m in ("smooth", "viterbi", "fit_vmp")},
    **{("HGF", m): ENTRY_POINT for m in ("init_state", "step", "log_likelihood", "filter")},
    **{("BinaryHGF", m): ENTRY_POINT for m in ("init_state", "step", "filter")},
    **{("SLDS", m): ENTRY_POINT for m in ("filter", "log_evidence", "sample")},
    **{("NonlinearSSM", m): ENTRY_POINT for m in ("filter", "smooth", "log_evidence",
                                                   "sample")},
    **{("PPCA", m): ENTRY_POINT for m in ("fit_em", "log_likelihood", "transform")},
    ("FactorAnalysis", "fit_em"): ENTRY_POINT,
    **{("GPSSM", m): ENTRY_POINT for m in ("posterior", "log_marginal_likelihood")},
    **{("GP", m): ENTRY_POINT for m in ("fit", "log_marginal_likelihood", "posterior")},
    **{("SGPR", m): ENTRY_POINT for m in ("fit", "elbo", "posterior")},
    **{("GPClassifier", m): ENTRY_POINT for m in ("fit", "posterior")},
    **{("BayesianAR", m): ENTRY_POINT for m in ("fit", "predict")},
    ("BOCPD", "filter"): ENTRY_POINT,
    ("GMM", "fit"): ENTRY_POINT,
    ("GMMFull", "fit"): ENTRY_POINT,
    ("EPClassifier", "fit"): ENTRY_POINT,
    ("BayesianLinearRegression", "fit"): ENTRY_POINT,
    ("PoissonRegression", "fit"): ENTRY_POINT,
    **{(cls, m): MODULE for cls, ms in (("LGSSM", ("extra_repr", "forward")),
                                        ("HMM", ("extra_repr", "forward")),
                                        ("HGF", ("extra_repr", "params")),
                                        ("BinaryHGF", ("extra_repr",)),
                                        ("SLDS", ("extra_repr", "forward", "K")))
       for m in ms},
}

# Instances the walk cannot make from fields: (JAX, port) built by the model's fit on
# the same numpy data, in every kind of the arguments.
_X_FIT = np.random.default_rng(12).normal(size=(12, D))
_Y_FIT = np.sin(_X_FIT[:, 0]) + 0.1 * np.random.default_rng(13).normal(size=12)
BUILT = {
    "GPPosterior": lambda m: m.GP().fit(_X_FIT, _Y_FIT),
    "SGPRPosterior": lambda m: m.SGPR().fit(_X_FIT, _Y_FIT, _X_FIT[:4]),
    "GPCPosterior": lambda m: m.GPClassifier(n_iters=5).fit(_X_FIT, np.sign(_Y_FIT)),
}

@functools.cache
def _built(name, pkg):
    return BUILT[name](PM if pkg == "port" else JM)


# Methods held at the bar of special functions or eliminations (else PLAIN).
SPECIAL_CLASSES = {"Beta", "Gamma", "Dirichlet", "NormalGamma", "Wishart", "Poisson",
                   "MvGaussian", "Bernoulli", "Categorical", "MvLGSSMParams", "GMMFullPosterior",
                   "GaussianNIG", "BernoulliBeta", "GPPosterior", "SGPRPosterior",
                   "GPCPosterior", "EPClassifierPosterior", "PoissonPosterior",
                   "BayesianLinearRegression"}


def _recipe(name, method, b):
    """``(object, arguments)`` of a call at batch ``b`` in recipe form: the
    object ``None`` for a class method, ``"built"`` for a BUILT posterior."""
    static = isinstance(inspect.getattr_static(CLASSES[name][0], method),
                        (classmethod, staticmethod))
    obj = None if static else "built" if name in BUILT else Inst(name, _fields(name, b))
    return obj, _args(name, method, b)


def _walk():
    methods, cases = [], []
    for name, (jcls, pcls) in CLASSES.items():
        for method in sorted(set(_public(jcls)) | set(_public(pcls))):
            methods.append((name, method))
            if (name, method) in EXCLUDED:
                continue
            obj, args = _recipe(name, method, B)
            kinds = list(_kinds(_array_leaves(obj), _array_leaves(args)))
            scalar = _array_leaves(_recipe(name, method, ()))
            if scalar and all(a.ndim == 0 for a in scalar):
                kinds.append("python")
            cases += [(name, method, kind) for kind in kinds]
    return methods, cases


METHODS, CASES = _walk()


def _call(name, method, kind, pkg, batch=None):
    """``name.method`` called in ``kind`` for ``pkg`` ("port"/"jax"), at
    ``batch`` (by default: scalars for the kind ``python``, else ``B``)."""
    cls = CLASSES[name][pkg == "port"]
    if batch is None:
        batch = () if kind == "python" else B
    obj, args = _recipe(name, method, batch)
    kinds = _kinds(_array_leaves(obj), _array_leaves(args))
    kinds["python"] = {id(a): "python" for a in _array_leaves((obj, args))}
    kind_map = kinds[kind]

    def kind_of(a):
        return kind_map.get(id(a), "tensor")

    if obj == "built":
        obj = _built(name, pkg)
    elif obj is not None:
        obj = _realize(obj, pkg, kind_of)
    args = _realize(args, pkg, kind_of)
    attr = inspect.getattr_static(cls, method)
    if isinstance(attr, property):
        return getattr(obj, method)
    if obj is None:
        return getattr(cls, method)(*args)
    return getattr(obj, method)(*args)


def _same(got, want, tol, where, draw=False):
    """``got`` (port) is what ``want`` (JAX) is: kind, dtype, shape, values."""
    if isinstance(want, jax.Array):
        assert isinstance(got, torch.Tensor), (where, type(got))
        assert got.device.type == "cpu", where
        assert str(got.dtype) == f"torch.{want.dtype}", (where, got.dtype, want.dtype)
        assert tuple(got.shape) == want.shape, (where, got.shape, want.shape)
        if not draw:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), *tol,
                                       err_msg=where)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (where, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_allclose(got, want, *tol, err_msg=where)
    elif isinstance(want, (bool, int, float)):
        assert type(got) is type(want), (where, type(got), type(want))
        np.testing.assert_allclose(got, want, *tol, err_msg=where)
    elif dataclasses.is_dataclass(want) or hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, where
        names = [f.name for f in dataclasses.fields(want)] if dataclasses.is_dataclass(
            want) else want._fields
        for field in names:
            _same(getattr(got, field), getattr(want, field), tol, f"{where}.{field}", draw)
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{where}[{i}]", draw)
    else:
        assert got == want, where


# Calls that JAX refuses, with what the port gives instead.
JAX_RAISES = {
    ("Gaussian", "sample", "python"): (
        AttributeError, "JAX reads the dtype of the field xi, which a Python float lacks; "
        "the port draws float32, as JAX draws from 0-d arrays"),
}


@pytest.mark.parametrize("name,method,kind", CASES,
                         ids=[f"{n}.{m}-{k}" for n, m, k in CASES])
def test_value_method_computes_as_jax_does(name, method, kind, on_cpu):
    got = _call(name, method, kind, "port")
    if (name, method, kind) in JAX_RAISES:
        with pytest.raises(JAX_RAISES[name, method, kind][0]):
            _call(name, method, kind, "jax")
        want = _call(name, method, "tensor", "jax", batch=())  # from 0-d arrays
    else:
        want = _call(name, method, kind, "jax")
    tol = SPECIAL if name in SPECIAL_CLASSES else PLAIN
    _same(got, want, tol, f"{name}.{method}", draw=method == "sample")
    if method == "sample" and kind in ("numpy", "python"):
        _hold_moments(name, kind)


def _hold_moments(name, kind):
    """Over N_DRAWS draws from the port, the sample mean lies within 5 standard
    errors of JAX's mean of the same values."""
    recipe = Inst(name, _fields(name, () if kind == "python" else B))
    jinst = _realize(recipe, "jax", lambda a: "numpy")
    port_kind = kind
    gen = torch.Generator().manual_seed(1)
    if name == "Wishart":  # one draw a replica: as many replicas as draws
        tiled = Inst(name, {k: np.broadcast_to(v, (N_DRAWS // 10,) + v.shape)
                            for k, v in recipe.fields.items()})
        pairs = [(_realize(tiled, "port", lambda a: port_kind).sample(gen), jinst.mean)]
    else:
        draws = _realize(recipe, "port", lambda a: port_kind).sample(gen, (N_DRAWS,))
        pairs = {
            "NormalGamma": lambda: [(draws[0], jinst.m), (draws[1], jinst.mean_tau)],
            "Categorical": lambda: [(torch.nn.functional.one_hot(draws.long(), K),
                                     jinst.probs)],
            "Bernoulli": lambda: [(draws, jinst.prob)],
            "Poisson": lambda: [(draws, jinst.rate)],
        }.get(name, lambda: [(draws, jinst.mean)])()
    for x, ref in pairs:
        x = x.double()
        se = x.std(0) / np.sqrt(x.shape[0])
        err = (x.mean(0) - torch.from_numpy(np.asarray(ref, np.float64))).abs()
        assert bool((err <= 5.0 * se + 1e-6).all()), (name, err, se)


def test_every_public_method_is_walked_or_excluded_with_a_reason():
    """The walk covers every method of every value class: a method added later
    is walked (or fails for want of arguments) unless it stands in EXCLUDED;
    no exclusion is stale, and each counterpart exists in the port."""
    walked = {(n, m) for n, m, _ in CASES}
    assert set(METHODS) == walked | set(EXCLUDED)
    assert not walked & set(EXCLUDED)
    assert set(EXCLUDED) <= set(METHODS), set(EXCLUDED) - set(METHODS)
    assert all(reason for reason in EXCLUDED.values())
    for name, method in walked:
        assert hasattr(CLASSES[name][0], method) and hasattr(CLASSES[name][1], method)
    # Every method that computes on fields is walked in more than one kind.
    assert all(len({k for n, m, k in CASES if (n, m) == nm}) >= 2 for nm in walked
               if nm[0] not in ("GaussianNIG", "BernoulliBeta") or nm[1] != "init_stats")


ALONE = {
    "Beta.entropy": lambda: P.Beta(np.ones(3), np.full(3, 2.0)).entropy(),
    "Gamma.kl": lambda: P.Gamma(2.0, 1.0).kl(P.Gamma(np.ones(3), np.ones(3))),
    "Poisson.rate": lambda: P.Poisson(np.zeros(3)).rate,
    "Beta.sample": lambda: P.Beta(2.0, 3.0).sample(torch.Generator()),
    "LGSSMParams.Q": lambda: PM.LGSSMParams(0.9, 0.0, 0.0).Q,
    "GaussianNIG.init_stats": lambda: PM.GaussianNIG().init_stats((3,), torch.float32),
}


@pytest.mark.parametrize("name", list(ALONE))
def test_values_alone_go_to_the_card_never_to_the_host_unasked(name):
    """With no tensor among the fields and arguments, values go to the card:
    without one the call raises as torch raises, and computes nothing on the
    host."""
    if torch.cuda.is_available():
        out = ALONE[name]()
        assert all(t.device.type == "cuda" for t in tree.tree_leaves(out))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            ALONE[name]()


def test_a_cpu_tensor_takes_the_numpy_values_beside_it_to_the_cpu():
    """The first tensor among the fields and the arguments names the device;
    nothing is patched; the numpy-only arithmetic stays numpy."""
    a = torch.full((3,), 2.0)
    outs = [
        P.Beta(np.ones(3), a).entropy(),
        P.Beta(np.ones(3), np.ones(3)).kl(P.Beta(a, a)),
        P.Gaussian(a, a).logpdf(np.zeros(3)),
        P.NormalGamma(a, a, a, a).expected_tau_sq_diff(np.zeros(3)),
        P.Beta(np.ones(3), a).mean,
        PM.LGSSMParams(a, 0.0, np.zeros(3)).R,
    ]
    for out in outs:
        assert out.device.type == "cpu" and out.dtype == torch.float32
    assert type(P.Beta(np.ones(3), np.full(3, 2.0)).mean) is np.ndarray


def test_chip_smoke_values_phase_rehearses_on_cpu(on_cpu):
    """Phase 25 of chip_smoke.py at a small size: the coin toss fed numpy with
    a prior of Python floats, and every method of every value class fed
    numpy, on the CPU, equal bit for bit to the calls fed the tensors that
    numpy's rounding gives, numpy float64 where the JAX package computes in
    numpy."""
    from cortex_tpu_torch import compile as port_compile, core

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {"star": (50, 6), "replicas": 40, "K": 3, "d": 2, "window": 4, "fit": 16,
              "gp": 8}
    data = smoke.values_data(shapes)
    star = smoke.run_values_star(torch, P, port_compile, core, "cpu", data["flips"])
    assert star["device"] == "cpu" and star["replicas"] == 50
    checks = smoke.run_values(torch, P, PM, "cpu", data)
    assert [c["class"] for c in checks] == list(smoke.VALUE_DISTS + smoke.VALUE_MODELS)
    walked = {(n, m) for n, m, _ in CASES}
    assert sum(c["methods"] for c in checks) == len(walked)
    numpy_results = {f"{c['class']}.{m}" for c in checks for m in c["numpy_results"]}
    assert numpy_results == smoke.NUMPY_RESULTS
    for check in checks:
        assert check["bit_equal"] and set(check["devices"]) <= {"cpu"}
