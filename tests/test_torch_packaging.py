"""The port's packaging: an installed ``rscm_tpu_torch`` has every package,
its kernels' and native code's sources and the compat layer's stubs.

``pyproject.toml`` lists packages by hand, so a package added without an
entry is left out of a wheel; package data likewise.  The native loader
and ``ops/build.py`` read their sources relative to the package, so
those sources must lie inside it (the repository's top-level ``native/``
is not installed).
"""

import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "rscm_tpu_torch"


def setuptools_config():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def shipped_data():
    """The files under the package that its package-data patterns match."""
    patterns = setuptools_config()["package-data"]["rscm_tpu_torch"]
    return {p.relative_to(PACKAGE).as_posix() for pattern in patterns
            for p in PACKAGE.glob(pattern) if p.is_file()}


def test_every_package_of_the_port_is_listed():
    listed = set(setuptools_config()["packages"])
    found = {".".join(init.parent.relative_to(ROOT).parts)
             for init in PACKAGE.rglob("__init__.py") if "_build" not in init.parts}
    assert "rscm_tpu_torch.compat._lib.core" in found
    assert sorted(found - listed) == []


#: what an installed port reads from files beside its modules
DATA = {
    "kernel sources": "csrc/*.cu",
    "native sources": "native/src/*.cpp",
    "compat stubs": "compat/_lib/**/*.pyi",
    "compat marker": "compat/py.typed",
}


@pytest.mark.parametrize("what", list(DATA))
def test_package_data_ships(what):
    wanted = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.glob(DATA[what])}
    assert wanted, f"no {what} in the tree"
    assert sorted(wanted - shipped_data()) == []


#: where the installed port reads sources from, and the sources it reads there
SOURCES = {
    "native._NATIVE_DIR": ("graph_engine.cpp", "csv_loader.cpp"),
    "ops.build.CSRC": ("udeb_year.cu", "lamcalc.cu"),
}


@pytest.mark.parametrize("where", list(SOURCES))
def test_sources_are_read_from_inside_the_package(where):
    import importlib

    module, name = where.rsplit(".", 1)
    path = Path(getattr(importlib.import_module(f"rscm_tpu_torch.{module}"), name)).resolve()
    assert path.is_relative_to(PACKAGE.resolve()), path
    for source in SOURCES[where]:
        assert (path / source).is_file(), source
