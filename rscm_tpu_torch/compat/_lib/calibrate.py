"""``rscm._lib.calibrate`` — calibration primitives."""

from ..calibrate import *  # noqa: F401,F403
from ..calibrate import __all__  # noqa: F401
