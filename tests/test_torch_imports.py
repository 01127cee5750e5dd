"""The port stands alone: no JAX, nothing of ``rscm_tpu`` or ``rscm``.

- Every module of ``rscm_tpu_torch`` imports in a fresh interpreter where
  ``import jax`` fails, and the MAGICC graph and the flagship graph build
  and run there (the flagship through both executors).
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
FORBIDDEN = {"jax", "jaxlib", "rscm_tpu", "rscm", "optax"}


def port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(rscm_tpu_torch.__path__, prefix="rscm_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    modules = port_modules()
    assert "rscm_tpu_torch.magicc.climate.udeb" in modules
    assert "rscm_tpu_torch.compat._lib.core.state" in modules
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


MAGICC_MODULES = [
    "rscm_tpu_torch.magicc.chemistry.prescribed",
    "rscm_tpu_torch.magicc.chemistry.ch4",
    "rscm_tpu_torch.magicc.chemistry.n2o",
    "rscm_tpu_torch.magicc.forcing.ghg",
    "rscm_tpu_torch.magicc.forcing.ozone",
    "rscm_tpu_torch.magicc.forcing.aerosol_direct",
    "rscm_tpu_torch.magicc.forcing.aerosol_indirect",
    "rscm_tpu_torch.magicc.carbon.terrestrial",
    "rscm_tpu_torch.magicc.carbon.ocean",
    "rscm_tpu_torch.magicc.carbon.budget",
    "rscm_tpu_torch.magicc.coupled",
]


def test_magicc_graph_builds_and_runs_without_jax():
    """The ten-component graph's modules import, and a short graph builds
    and runs on the CPU, in an interpreter where ``import jax`` fails."""
    assert set(MAGICC_MODULES) <= set(port_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {MAGICC_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np\n"
        "from rscm_tpu_torch.magicc.coupled import build_magicc_model\n"
        "model = build_magicc_model(years=np.arange(1850.0, 1856.0))\n"
        "model.run(device='cpu')\n"
        "co2 = model.collection.get_data('Atmospheric Concentration|CO2').values()\n"
        "assert np.isfinite(np.asarray(co2)[1:]).all()\n"
        "assert not any(m == 'rscm_tpu' or m.startswith(('rscm_tpu.', 'rscm.')) or m == 'rscm'"
        " for m in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


FLAGSHIP_MODULES = [
    "rscm_tpu_torch.core.ivp",
    "rscm_tpu_torch.core.example_components",
    "rscm_tpu_torch.core.python_component",
    "rscm_tpu_torch.components.two_layer",
    "rscm_tpu_torch.components.carbon_cycle",
    "rscm_tpu_torch.components.co2_erf",
    "rscm_tpu_torch.components.four_box_ocean_heat_uptake",
    "rscm_tpu_torch.components.ocean_surface_partial_pressure",
    "rscm_tpu_torch.magicc.chemistry.halocarbon",
]


def test_flagship_graph_builds_and_steps_without_jax():
    """The flagship slice's modules import, and a short flagship graph runs
    through the year loop and the step-by-step executor, in an interpreter
    where ``import jax`` fails."""
    assert set(FLAGSHIP_MODULES) <= set(port_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {FLAGSHIP_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_support import build_flagship\n"
        "years = np.arange(1750.0, 1760.0)\n"
        "loop, stepped = build_flagship('rscm_tpu_torch', years), build_flagship('rscm_tpu_torch', years)\n"
        "loop.run(device='cpu')\n"
        "stepped.step(device='cpu')\n"
        "stepped.run(compiled=False, device='cpu')\n"
        "a, b = (m.collection.get_data('Surface Temperature').values() for m in (loop, stepped))\n"
        "assert np.isfinite(a).all() and np.array_equal(a, b)\n"
        "assert not any(m == 'rscm_tpu' or m.startswith(('rscm_tpu.', 'rscm.')) or m == 'rscm'"
        " for m in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


CALIBRATION_MODULES = [
    "rscm_tpu_torch.calibrate",
    "rscm_tpu_torch.calibrate.distribution",
    "rscm_tpu_torch.calibrate.parameter_set",
    "rscm_tpu_torch.calibrate.target",
    "rscm_tpu_torch.calibrate.likelihood",
    "rscm_tpu_torch.calibrate.model_runner",
    "rscm_tpu_torch.calibrate.gradients",
    "rscm_tpu_torch.calibrate.chain",
    "rscm_tpu_torch.calibrate.progress",
    "rscm_tpu_torch.calibrate.pandas_helpers",
    "rscm_tpu_torch.calibrate.point_estimator",
    "rscm_tpu_torch.calibrate.sampler",
    "rscm_tpu_torch.calibrate.nuts",
    "rscm_tpu_torch.magicc.calibration",
    "rscm_tpu_torch.ops.plain_grad",
]


def test_calibration_runs_without_jax_pandas_or_optax():
    """The calibration modules import, export the JAX package's
    ``__all__``, and a short MAGICC calibration builds and evaluates a
    batch of walkers with its gradient, in an interpreter where ``jax``,
    ``pandas`` and ``optax`` cannot be imported."""
    assert set(CALIBRATION_MODULES) <= set(port_modules())
    from rscm_tpu.calibrate import __all__ as reference_all

    code = (
        "import sys\n"
        "for name in ('jax', 'pandas', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {CALIBRATION_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np, torch\n"
        "import rscm_tpu_torch.calibrate as calibrate\n"
        "from rscm_tpu_torch.calibrate.gradients import value_and_grad\n"
        "from rscm_tpu_torch.magicc.calibration import magicc_calibration\n"
        f"assert set({sorted(reference_all)!r}) <= set(calibrate.__all__)\n"
        "c = magicc_calibration(years=np.arange(1850.0, 1856.0), obs_interval=2, device='cpu')\n"
        "lp = calibrate.EnsembleSampler(c.params, c.runner, c.likelihood, c.target)"
        "._build_device_log_prob()\n"
        "values, grads = value_and_grad(lp, torch.tensor(np.stack([c.theta_true] * 2)), 'rev')\n"
        "assert values.shape == (2,) and grads.shape == (2, 8)\n"
        "assert bool(torch.isfinite(values).all()) and bool(torch.isfinite(grads).all())\n"
        "assert not any(m == 'rscm_tpu' or m.startswith(('rscm_tpu.', 'rscm.')) or m == 'rscm'"
        " for m in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
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


SCANNED = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "rscm_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"
]


@pytest.mark.parametrize("path", SCANNED)
def test_no_forbidden_imports(path):
    assert not imported_roots(ROOT / path) & FORBIDDEN


def test_compat_surface_is_scanned_and_registers_no_rscm():
    """The reference-API surface (``rscm_tpu_torch.compat``) is part of the
    scan, and importing it leaves ``rscm`` out of ``sys.modules``: the name
    is taken only by ``install_as_rscm()``."""
    compat = {str(p.relative_to(ROOT)) for p in (ROOT / "rscm_tpu_torch" / "compat").rglob("*.py")}
    assert "rscm_tpu_torch/compat/_lib/core/state.py" in compat
    assert compat <= set(SCANNED)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import rscm_tpu_torch.compat\n"
        "import rscm_tpu_torch.compat._lib.core.state\n"
        "import rscm_tpu_torch.compat.config.models.magicc.legacy\n"
        "assert not any(m == 'rscm' or m.startswith('rscm.') for m in sys.modules), 'rscm registered'\n"
        "assert not any(type(f).__module__.startswith('rscm_tpu_torch') for f in sys.meta_path)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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
