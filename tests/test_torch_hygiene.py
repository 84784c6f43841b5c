"""The port under the repository's static gates.

The gates of ``tools/`` (lint, format, the call-interface check) and the
hygiene checks of ``tests/test_hygiene.py`` (every module imports, its
``__all__`` names exist, its public classes and functions have docstrings),
run over ``cortex_tpu_torch``, ``chip_smoke.py`` and ``kernel_probe.py``
with the same rules as over the JAX package: zero findings.
"""

import importlib
import inspect
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import format as formatmod  # noqa: E402
import lint as lintmod  # noqa: E402
import typecheck  # noqa: E402

PATHS = [REPO / "cortex_tpu_torch", REPO / "chip_smoke.py", REPO / "kernel_probe.py"]
# Every file of the package, as a module name.
MODULES = sorted(".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                 for f in (REPO / "cortex_tpu_torch").rglob("*.py"))


def _files():
    return [f for p in PATHS for f in (sorted(p.rglob("*.py")) if p.is_dir() else [p])]


def _report(findings):
    return "\n".join(" ".join(map(str, f)) for f in findings)


def test_port_lints_clean():
    findings = lintmod.lint([str(p) for p in PATHS])
    assert findings == [], _report(findings)


def test_port_formats_clean():
    findings = [f for path in _files() for f in formatmod.check_file(path)]
    assert findings == [], _report(findings)


def test_port_passes_the_call_interface_check(monkeypatch):
    monkeypatch.setattr(typecheck, "PACKAGE", "cortex_tpu_torch")
    findings = typecheck.typecheck([str(REPO / "cortex_tpu_torch")])
    assert findings == [], _report(findings)


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_and_exports_exist(name):
    mod = importlib.import_module(name)
    for export in getattr(mod, "__all__", []):
        assert hasattr(mod, export), f"{name}.__all__ lists missing {export!r}"


@pytest.mark.parametrize("name", MODULES)
def test_public_api_documented(name):
    mod = importlib.import_module(name)
    assert mod.__doc__, f"{name} has no module docstring"
    for export in getattr(mod, "__all__", []):
        obj = getattr(mod, export)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__doc__, f"{name}.{export} has no docstring"
