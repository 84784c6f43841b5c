"""``chip_smoke.py`` itself: each top-level name is defined once, and the
zoo phases (20-21) rehearse on the CPU at a small size.

The rehearsal runs ``run_zoo_main_path`` on the CPU, where the card's run and
the CPU run coincide: it holds every path to its float64 numpy reference at
the bars of ZOO_TOL, and shows that no path reaches K1-K4.
"""

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from cortex_tpu_torch import models, ops
from cortex_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
SMALL = {"nlssm": (16, 20), "gabp": (4, 8, 8, 60), "hmc": (16, 4, 60, 60, 8),
         "glm": (2000, 8), "ar": (32, 200, 4), "latent_ar": (16, 30), "gp": 300,
         "sgpr": (2000, 32), "gpc": 200, "gpssm": (300, 600), "ppca": (2000, 16, 3, 30),
         "bocpd": (8, 200, 64)}
REFS = {"nlssm": 8, "nlssm_cpu": 16, "gabp": 4, "ar": 16, "latent_ar": 8, "cpu_n": 500,
        "gpc_cpu": 100, "bocpd": 4, "bocpd_cpu": 8, "gpssm_stride": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the test runner's
    workers share the cores (a worker's default threads oversubscribe them:
    an HMC test took 30 s under load against 4 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_each_function_is_defined_once():
    """A later definition of a top-level name silently replaces the earlier
    one: every function, class and constant of the script is defined once."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"defined more than once in chip_smoke.py: {twice}"
    assert {"run_zoo_main_path", "phase_zoo_main_path", "zoo_sharded_rank"} <= set(names)


def test_chip_smoke_zoo_main_path_rehearses_on_cpu():
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0
    checks = _chip_smoke().run_zoo_main_path(torch, models, ops, "cpu", shapes=SMALL, refs=REFS)
    assert not any(kernels.LAUNCHES.values())
    paths = {c["path"] for c in checks}
    assert {"NonlinearSSM.smooth ukf", "linear NonlinearSSM.smooth ekf", "gabp_solve", "HMC",
            "BayesianLinearRegression.fit", "EPClassifier probit", "cvi logistic",
            "PoissonRegression.fit", "BayesianAR.fit", "latent_ar_smooth", "GP.fit + predict",
            "SGPR.fit + predict", "SGPR.elbo", "GPClassifier.fit", "GPSSM matern52",
            "ppca_closed_form", "PPCA.fit_em", "FactorAnalysis.fit_em",
            "BOCPD BernoulliBeta"} <= paths
