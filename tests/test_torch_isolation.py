"""The port stands alone: ``import repro_torch`` and every submodule work
with ``jax`` blocked, and no file of the port (nor ``chip_smoke.py``)
imports ``jax`` or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

BLOCKER = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k in sys.modules)
print(len(names))
"""


def port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_import_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKER], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25      # every module was imported


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_config_module_is_checked():
    """Each config module of the port (deepseek-v2-236b's, the last one
    ported, among them) is one of the files the import check reads, and
    the blocked-import run imports it."""
    configs = {p.name for p in (PORT / "configs").glob("*.py")}
    assert "deepseek_v2_236b.py" in configs
    assert configs <= {p.name for p in port_files()
                       if p.parent.name == "configs"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = BLOCKER.replace(
        "print(len(names))",
        "print('repro_torch.configs.deepseek_v2_236b' in names)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_dry_run_modules_are_checked():
    """The dry run and its analysis (the hardware table, the no-data
    branch of the kernels, the cost counter, the roofline) are among the
    files the import check reads, and the blocked-import run imports
    them."""
    new = ("launch/dryrun.py", "launch/mesh.py", "analysis/costs.py",
           "analysis/roofline.py", "kernels/fake.py")
    assert {PORT / n for n in new} <= set(port_files())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    mods = [f"repro_torch.{n[:-3].replace('/', '.')}" for n in new]
    code = BLOCKER.replace("print(len(names))",
                           f"print(all(m in names for m in {mods!r}))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"



LINT_MODULES = ("__init__", "__main__", "baseline", "cli", "core", "report",
                "rules")


def test_lint_modules_are_checked():
    """The port's tracelint (``analysis/lint/``, seven modules) is among
    the files the import check reads, and it is pure stdlib: it imports
    and lints with torch blocked as well as jax and the JAX package."""
    lint = PORT / "analysis" / "lint"
    assert {lint / f"{m}.py" for m in LINT_MODULES} <= set(port_files())
    for m in LINT_MODULES:
        bad = [(line, mod) for line, mod in imported_modules(lint / f"{m}.py")
               if mod.split(".")[0] in FORBIDDEN + ("torch", "numpy")]
        assert not bad, f"analysis/lint/{m}.py imports {bad}"
    code = BLOCKER.split("sys.meta_path.insert(0, Block())")[0].replace(
        '("jax", "jaxlib", "repro")', '("jax", "jaxlib", "repro", "torch")'
    ) + """
sys.meta_path.insert(0, Block())
mods = [f"repro_torch.analysis.lint.{m}" for m in
        ("baseline", "cli", "core", "report", "rules")]
for name in mods:
    importlib.import_module(name)
from repro_torch.analysis.lint import lint_sources
found = lint_sources({"core/progs.py":
                      "def charge_decision(p, v, r):\\n"
                      "    return v.usage.item()\\n"})
assert "torch" not in sys.modules
print([f.rule for f in found])
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['TL001']"
