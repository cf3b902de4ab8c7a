"""The port imports neither JAX nor the JAX package.

Two checks: a subprocess that imports every module of ``repro_torch`` and
then looks at ``sys.modules`` (a subprocess, because ``tests/conftest.py``
has already imported JAX into this process), and an AST scan of every
source file of the port and of ``chip_smoke.py``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_scan_covers_the_port():
    assert len(SOURCES) >= 15 and (ROOT / "chip_smoke.py").exists()


# the modules of the dense-training and cluster slice: the walk above
# must reach each (a module it misses is a module the guard never checks)
SLICE_4_MODULES = [
    "repro_torch.cluster", "repro_torch.cluster.slices",
    "repro_torch.cluster.straggler", "repro_torch.cluster.supercomputer",
    "repro_torch.core", "repro_torch.core.autotopo",
    "repro_torch.core.costmodel", "repro_torch.core.goodput",
    "repro_torch.core.ocs", "repro_torch.core.scheduler",
    "repro_torch.core.topology", "repro_torch.parallel",
    "repro_torch.parallel.context", "repro_torch.train.checkpoint",
    "repro_torch.launch.quickstart",
]


@pytest.mark.parametrize("module", SLICE_4_MODULES)
def test_guard_walks_the_module(module):
    assert module in _module_names()
    path = PKG.joinpath(*module.split(".")[1:])
    assert (path.with_suffix(".py") if path.with_suffix(".py").exists()
            else path / "__init__.py") in SOURCES


# the fleet, the registry and the tenancy (slice 5) and the examples'
# twins: the walk above must reach each
SLICE_5_MODULES = [
    "repro_torch.fleet", "repro_torch.fleet.autoscaler",
    "repro_torch.fleet.replica", "repro_torch.fleet.router",
    "repro_torch.fleet.service", "repro_torch.fleet.traffic",
    "repro_torch.cluster.registry", "repro_torch.cluster.tenancy",
    "repro_torch.launch.serve_fleet", "repro_torch.launch.mixed_cluster",
]


@pytest.mark.parametrize("module", SLICE_5_MODULES)
def test_guard_walks_the_slice_5_module(module):
    assert module in _module_names()
    path = PKG.joinpath(*module.split(".")[1:])
    assert (path.with_suffix(".py") if path.with_suffix(".py").exists()
            else path / "__init__.py") in SOURCES
