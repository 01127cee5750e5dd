"""``rscm._lib.two_layer`` — the two-layer component builder."""

from ..two_layer import *  # noqa: F401,F403
from ..two_layer import __all__  # noqa: F401
