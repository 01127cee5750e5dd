"""
rscm_tpu_torch.compat — the reference's Python API over the PyTorch/CUDA port.

The counterpart of the ``rscm`` package (which wraps the JAX engine): it
preserves lewisjared/rscm's public Python API, so code and notebooks
written against the reference run on the CUDA card:

- ``compat.core`` — engine types (ModelBuilder, TimeAxis, Timeseries, ...)
- ``compat.component`` — typed Python components (Input/Output/State)
- ``compat.components`` / ``compat.two_layer`` / ``compat.magicc`` — builders
- ``compat.calibrate`` — calibration framework
- ``compat.config`` — layered TOML config system
- ``compat._lib`` — the reference's native-extension import paths

The reference's own names (``import rscm``, ``rscm._lib.core.state``, ...)
resolve here once :func:`install_as_rscm` has run; importing this package
registers nothing under them.

The reference engine is Rust float64. ``rscm`` enables JAX's x64 flag on
import to keep that contract; the port needs no flag, because it runs in
float64 from numpy inputs, so this package sets no global state (and
leaves ``torch``'s default dtype alone).
"""

import importlib
import importlib.abc
import importlib.util
import sys

from ._lib import __version__  # noqa: F401

_ALIAS = "rscm"


def _is_ours(module) -> bool:
    name = getattr(module, "__name__", "")
    return name == "rscm_tpu_torch" or name.startswith("rscm_tpu_torch.")


class _RscmFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``rscm`` and every ``rscm.<path>`` to this package's module
    of the same path (the module object itself, under both names)."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != _ALIAS and not fullname.startswith(_ALIAS + "."):
            return None
        real = __name__ + fullname[len(_ALIAS):]
        if importlib.util.find_spec(real) is None:
            return None
        return importlib.util.spec_from_loader(fullname, self, origin=real)

    def create_module(self, spec):
        module = importlib.import_module(spec.origin)
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set the alias's spec on the module: give the
        # module back its own
        module.__spec__ = module.__spec__.loader_state


_FINDER = _RscmFinder()


def install_as_rscm() -> None:
    """Make ``import rscm`` (and every ``rscm.*`` path of the reference
    package, ``rscm._lib.*`` included) resolve to this package.

    Code written against the reference then runs on the port unchanged.
    Raises ``ImportError`` when a different ``rscm`` (the JAX package's
    compat surface, say) is already imported: the two never mix. Calling
    it again is a no-op.
    """
    foreign = sorted(
        name
        for name, module in sys.modules.items()
        if (name == _ALIAS or name.startswith(_ALIAS + ".")) and not _is_ours(module)
    )
    if foreign:
        raise ImportError(
            f"a different {_ALIAS!r} is already imported ({', '.join(foreign)}); "
            f"install_as_rscm() must run before anything imports it"
        )
    if _FINDER not in sys.meta_path:
        sys.meta_path.insert(0, _FINDER)
