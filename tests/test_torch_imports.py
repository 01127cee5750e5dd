"""The port stands alone: no JAX, nothing of ``rscm_tpu`` or ``rscm``.

- Every module of ``rscm_tpu_torch`` imports in a fresh interpreter where
  ``import jax`` fails.
- No module of the port, and not ``chip_smoke.py``, imports ``jax``,
  ``rscm_tpu`` or ``rscm`` anywhere (an AST scan, so imports inside
  functions count too).
- ``chip_smoke.py`` fails, and prints no result, where it cannot run: here
  without a CUDA card, and alone in a directory without the package.
"""

import ast
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import rscm_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "rscm_tpu", "rscm"}


def port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(rscm_tpu_torch.__path__, prefix="rscm_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    modules = port_modules()
    assert "rscm_tpu_torch.magicc.climate.udeb" in modules
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'rscm_tpu' or m.startswith(('rscm_tpu.', 'rscm.')) or m == 'rscm'"
        " for m in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def imported_roots(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "rscm_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_forbidden_imports(path):
    assert not imported_roots(ROOT / path) & FORBIDDEN


def run_smoke(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert '"kernels"' not in out.stdout
