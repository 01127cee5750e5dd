"""``rscm._lib.core`` — the reference's native core module surface."""

from ...core import *  # noqa: F401,F403
from ...core import __all__ as _core_all
from ...example_components import TestComponent, TestComponentBuilder  # noqa: F401

from . import spatial, state  # noqa: F401

__all__ = list(_core_all) + [
    "TestComponent",
    "TestComponentBuilder",
    "state",
    "spatial",
]
