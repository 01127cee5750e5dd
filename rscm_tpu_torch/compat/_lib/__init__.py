"""Stand-in for the reference's native extension module.

The reference builds ``rscm._lib`` from Rust (PyO3) with submodules
``core`` / ``core.state`` / ``core.spatial`` / ``two_layer`` /
``components`` / ``magicc`` / ``calibrate``; here the same paths, under
this package, resolve to the port's engine, so code written against the
reference imports unchanged once :func:`rscm_tpu_torch.compat.install_as_rscm`
has run.
"""

from rscm_tpu_torch import __version__

from . import calibrate, components, core, magicc, two_layer  # noqa: F401

__all__ = [
    "__version__",
    "core",
    "two_layer",
    "components",
    "magicc",
    "calibrate",
]
