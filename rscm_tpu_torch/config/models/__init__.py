"""Model-family config modules; importing registers their builders."""

from . import magicc, two_layer  # noqa: F401
from .two_layer import TwoLayerConfig, TwoLayerParameters  # noqa: F401

__all__ = ["magicc", "two_layer", "TwoLayerConfig", "TwoLayerParameters"]
