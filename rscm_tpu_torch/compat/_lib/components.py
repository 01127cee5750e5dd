"""``rscm._lib.components`` — basic component builders."""

from ..components import *  # noqa: F401,F403
from ..components import __all__  # noqa: F401
