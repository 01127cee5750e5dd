"""Config system (reference surface of ``rscm.config``).

Every submodule path the reference package exposes
(``python/rscm/config/``) is registered under this package's name, so
``import <this package>.models.magicc.legacy`` and the rest resolve to the
port's ``rscm_tpu_torch.config`` modules.
"""

import importlib as _importlib
import sys as _sys

from rscm_tpu_torch.config import *  # noqa: F401,F403
from rscm_tpu_torch.config import __all__ as _all
from rscm_tpu_torch.config import models  # noqa: F401

for _sub in (
    "base",
    "builder",
    "docs",
    "exceptions",
    "loader",
    "models",
    "models.magicc",
    "models.magicc.legacy",
    "models.magicc.parameters",
    "models.two_layer",
    "parameters",
    "registry",
    "validation",
):
    _sys.modules[__name__ + "." + _sub] = _importlib.import_module(
        "rscm_tpu_torch.config." + _sub
    )

__all__ = list(_all) + ["models"]
